"""WEIGHT_STANDARDISATION in cmrtpu_torch against cmrtpu's ``WSConv`` arm.

* The forward of a WS U-Net on cmrtpu's weights (2D and 3D, f32): within
  1e-4 of ``model.apply``. Under MIXED_PRECISION the unnormalised net
  rounds far more than a normed one; the port's bf16 output lies within
  1.25x of cmrtpu's own bf16-to-f32 distance of cmrtpu's bf16 output.
* ``WSConv`` standardises: a shifted and rescaled raw kernel gives the same
  output (cmrtpu's ``test_weight_standardisation_variant``); no norm in a
  block, a gain per output channel, no (2+1)D factorisation.
* One fused train step with AGC 0.08 (f32, dropout 0) against cmrtpu's
  ``make_cached_train_step``: loss and metrics within rel 1e-5, every
  updated parameter within 2e-5, 2% of one Adam step at lr 1e-3 (an
  element whose gradient is near zero moves by lr * m / (sqrt(v) + eps),
  which the two frameworks' float32 rounding moves; measured 1.1e-5).
* ``model.npz`` both ways, and a WS fold trained by cmrtpu's Trainer
  served by the port's ``Predictor`` within 1e-4 of cmrtpu's predict.
* A fold cmrtpu wrote with WSConv_0 (and one with BN_BF16) served by the
  port's ``cli.serve``: its label files equal cmrtpu's.
* Without WS_I_UNDERSTAND the factory raises, as cmrtpu's.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.eval.detection import \
    localisation_metrics as jax_localisation_metrics
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu.train import steps as S
from cmrtpu.train.device_cache import make_cached_train_step, upload_cache
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu.train.optimizers import get_optimizer as jax_get_optimizer
from cmrtpu.train.trainer import Trainer as JaxTrainer
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import WSConv, build_model
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict, load_weights,
                                           save_weights, state_dict_to_flax)
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG as TRAIN_CFG
from test_torch_train import _labels
from test_torch_unet import perturbed_variables

torch.set_num_threads(1)

WS = {"DIM": [32, 32], "DEPTH": 3, "FILTERS": 8, "MASK_CLASSES": 2,
      "MIXED_PRECISION": False, "WEIGHT_STANDARDISATION": True,
      "WS_I_UNDERSTAND": True, "BATCH_NORMALISATION": True}
F32_ATOL = 1e-4
BF16_FACTOR = 1.25


def _3d(cfg):
    return dict(cfg, DIM=[4, 32, 32], F_SIZE=[3, 3, 3], M_POOL=[1, 2, 2])


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port(cfg, variables):
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables.get("batch_stats")))
    return model.eval()


def _forwards(cfg, seed=0):
    variables = perturbed_variables(cfg, seed, conv_bias=False)
    x = np.random.default_rng(seed + 1).standard_normal(
        (3, *cfg["DIM"], 1)).astype(np.float32)
    ref = np.asarray(jax_build_model(cfg).apply(variables, x, train=False))
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x)).numpy()
    return variables, x, ref, got


@pytest.mark.parametrize("cfg", [WS, _3d(WS), dict(WS, ACTIVATION="elu")],
                         ids=["2d", "3d", "elu"])
def test_forward_matches_cmrtpu_f32(cfg):
    variables, _, ref, got = _forwards(cfg)
    assert not variables.get("batch_stats")  # no norm anywhere
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def test_forward_matches_cmrtpu_mixed_precision():
    cfg = dict(WS, MIXED_PRECISION=True)
    variables, x, ref, got = _forwards(cfg)
    ref32 = np.asarray(jax_build_model(dict(cfg, MIXED_PRECISION=False))
                       .apply(variables, x, train=False))
    own = np.abs(ref - ref32)
    diff = np.abs(got - ref)
    assert diff.max() <= BF16_FACTOR * own.max(), (diff.max(), own.max())
    assert diff.mean() <= BF16_FACTOR * own.mean(), (diff.mean(),
                                                      own.mean())


def test_ws_blocks_are_normalisation_free():
    model = build_model(_3d(dict(WS, MODEL_VARIANT="unet_2p1d",
                                 FACTORIZED_3D=True)))
    keys = set(model.state_dict())
    assert not any("Norm" in k for k in keys)
    assert "DownBlock_0.ConvBlock_0.WSConv_0.gain" in keys
    assert "DownBlock_0.ConvBlock_0.Conv_1.weight" not in keys  # unfactorized
    block = model.DownBlock_0.ConvBlock_0
    assert block.ws_gamma == pytest.approx(1.7139)
    assert build_model(dict(WS, ACTIVATION="elu")).DownBlock_0.ConvBlock_0 \
        .ws_gamma == pytest.approx(1.2717)


def test_wsconv_standardises_its_kernel():
    conv = WSConv(2, 3, (3, 3))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        conv.weight.normal_(generator=gen)
        conv.gain.copy_(torch.tensor([0.5, 1.0, 2.0]))
    x = torch.randn(1, 2, 8, 8, generator=gen)
    with torch.no_grad():
        out = conv(x, torch.float32)
        k = conv.kernel()
        conv.weight.mul_(3.0).add_(7.0)
        shifted = conv(x, torch.float32)
    torch.testing.assert_close(out, shifted, rtol=0, atol=1e-4)
    # zero mean and variance gain^2 / fan_in per output channel
    flat = k.reshape(3, -1)
    torch.testing.assert_close(flat.mean(1), torch.zeros(3), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(flat.var(1, unbiased=False) * 18,
                               conv.gain.detach() ** 2, rtol=1e-5, atol=0)


def test_ws_train_step_with_agc_matches_cmrtpu():
    cfg = dict(TRAIN_CFG, GROUP_NORM=0, WEIGHT_STANDARDISATION=True,
               WS_I_UNDERSTAND=True, AGC=0.08, BATCHSIZE=8,
               LEARNING_RATE=1e-3)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = _labels(rng, 8, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg,
                               jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables))
    mesh = create_mesh(devices=jax.devices()[:1])
    optimizer = jax_get_optimizer(cfg)
    metrics = jax_default_metrics(2)
    metrics.update(jax_localisation_metrics(cfg))
    step = make_cached_train_step(model, optimizer, jax_get_loss(cfg),
                                  metrics, cfg, mesh, augment=False)
    state = S.create_train_state(model, variables, optimizer)
    dx, dy = upload_cache(xs, ys, mesh)
    new_state, ref_logs = step(state, dx, dy, jnp.arange(8, dtype=jnp.int32),
                               jax.random.key(0))

    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init["params"],
                                            init.get("batch_stats")))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    logs = DeviceCachedLoop(trainer, gen).train_step(torch.arange(8))
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
    params, _ = state_dict_to_flax(port.state_dict())
    got, want = _flat(params), _flat(new_state.params)
    assert got.keys() == want.keys()
    assert any(k.endswith("WSConv_0/gain") for k in got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-5,
                                   err_msg=name)


def test_npz_both_ways(tmp_path):
    cfg = _3d(WS)
    variables = perturbed_variables(cfg, 4)
    x = np.random.default_rng(4).standard_normal((2, *cfg["DIM"], 1)) \
        .astype(np.float32)
    ref = np.asarray(jax_build_model(cfg).apply(variables, x, train=False))
    # cmrtpu writes, the port reads
    jax_ckpt.save_weights(str(tmp_path / "jax"), variables["params"],
                          variables.get("batch_stats"))
    params, stats = load_weights(str(tmp_path / "jax"))
    model = _port(cfg, {"params": params, "batch_stats": stats})
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), ref,
                                   rtol=0, atol=F32_ATOL)
    # the port writes, cmrtpu reads
    save_weights(str(tmp_path / "port"), model)
    p2, s2 = jax_ckpt.load_weights(str(tmp_path / "port"))
    back = np.asarray(jax_build_model(cfg).apply(
        {"params": p2, "batch_stats": s2}, x, train=False))
    np.testing.assert_array_equal(back, ref)


def test_cmrtpu_trained_ws_fold_serves_from_the_port(tmp_path):
    cfg = dict(WS, DIM=[24, 24], MASK_VALUES=[1, 2], BATCHSIZE=8,
               LEARNING_RATE=1e-3, SEED=0, AUGMENT=False, SCALER="MinMax",
               GAUS=True, SIGMA=1, DROPOUT_MIN=0.0, DROPOUT_MAX=0.0)

    class G:
        masks = True

        def __init__(self):
            rng = np.random.default_rng(0)
            self._cache_x = rng.normal(size=(16, 24, 24)).astype(np.float32)
            y = np.zeros((16, 24, 24), np.float32)
            y[:, 4:6, 4:6] = 1
            y[:, 10:12, 10:12] = 2
            self._cache_y = y

    trainer = JaxTrainer(cfg)
    trainer.fit_cached(G(), epochs=2)
    model_dir = str(tmp_path / "model")
    jax_ckpt.save_weights(model_dir, trainer.state.params,
                          trainer.state.batch_stats)
    x = np.random.default_rng(1).normal(size=(3, 24, 24, 1)) \
        .astype(np.float32)
    want = np.asarray(trainer.predict(x))
    got = Predictor(cfg, model_dir, device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_ws_without_acknowledgement_raises():
    cfg = dict(WS, WS_I_UNDERSTAND=False)
    with pytest.raises(ValueError, match="WS_I_UNDERSTAND"):
        build_model(cfg)
    with pytest.raises(ValueError, match="WS_I_UNDERSTAND"):
        jax_build_model(cfg)


@pytest.mark.parametrize("extra", [
    {"WEIGHT_STANDARDISATION": True, "WS_I_UNDERSTAND": True},
    {"BATCH_NORMALISATION": True, "BN_BF16": True, "MIXED_PRECISION": True},
], ids=["ws", "bn_bf16"])
def test_cmrtpu_fold_serves_through_cli_serve(extra, tmp_path):
    """A fold cmrtpu wrote (WSConv_0 or BN_BF16 weights; the head scaled
    x50 so that labels sit far from 0.5) served by the port's cli.serve:
    every label file equal to cmrtpu's ``serve_directory``'s."""
    from cmrtpu.predict.serving import ServingEngine as JaxEngine
    from cmrtpu.predict.serving import serve_directory as jax_serve
    from cmrtpu_torch.cli.serve import main as serve_main
    from cmrtpu_torch.io import read_image
    from test_torch_serving import CFG as SERVE_CFG
    from test_torch_serving import STUDIES, _study

    cfg = dict(SERVE_CFG, GROUP_NORM=0, **extra)
    variables = perturbed_variables(cfg, 11, conv_bias=False)
    params = dict(variables["params"])
    params["head"] = {"kernel": params["head"]["kernel"] * 50.0,
                      "bias": params["head"]["bias"]}
    fold = tmp_path / "fold"
    jax_ckpt.save_weights(str(fold / "model"), params,
                          variables.get("batch_stats"))
    (fold / "config").mkdir()
    (fold / "config" / "config.json").write_text(json.dumps(cfg))
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for name, z, seed in STUDIES:
        _study(str(in_dir / name), z, seed)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jax_serve(JaxEngine(config=cfg, model_path=str(fold / "model")),
              str(in_dir), str(out_j))
    totals = serve_main(["-exp", str(fold), "-in", str(in_dir), "-out",
                         str(out_t), "--device", "cpu"])
    assert totals["studies"] == len(STUDIES)
    for name, _, _ in STUDIES:
        stem = name.split(".")[0]
        a = read_image(str(out_j / f"{stem}_msk_pred.nrrd")).array
        b = read_image(str(out_t / f"{stem}_msk_pred.nrrd")).array
        np.testing.assert_array_equal(b, a)
