"""cmrtpu_torch's multi-head (HEADS) modules against cmrtpu's on the CPU,
with the multihead template's heads [rvip, 2, sigmoid], [seg, 4, softmax].

* ``finalize_batch``: one-hot and binary channels exact, K1's heatmaps
  (the plain blur here) within 1e-5.
* ``multi_head_loss`` within rel 1e-5; the heads forward within 1e-4 (f32).
* The generator's head-mask sources (HEAD_MASK_RULES on the file name only)
  give cmrtpu's stacked label cache; augmentation warps every head of an
  example as cmrtpu does (masks exact).
* ``_head_outputs`` and the serving ``_flat_pred_heads`` equal.
* One fused train step of a HEADS BatchNorm U-Net (f32, ELU) against
  ``make_cached_train_step``: loss and the concatenated-head metrics within
  rel 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
from cmrtpu.pipeline.generator import finalize_batch as jax_finalize
from cmrtpu.predict import predictor as jax_predictor
from cmrtpu.predict import serving as jax_serving
from cmrtpu.train import losses as jl
from cmrtpu.train import steps as S
from cmrtpu.train.device_cache import make_cached_train_step, upload_cache
from cmrtpu.train.optimizers import get_optimizer as jax_get_optimizer
from cmrtpu_torch.io import MedicalImage, write_image
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.pipeline.augment import apply_params
from cmrtpu_torch.pipeline.generator import DataGenerator, finalize_batch
from cmrtpu_torch.predict import predictor as port_predictor
from cmrtpu_torch.predict import serving as port_serving
from cmrtpu_torch.train import losses as tl
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_augment import _jax_augment, _params
from test_torch_train import CFG, _labels
from test_torch_unet import perturbed_variables

torch.set_num_threads(1)

HEADS = [["rvip", 2, "sigmoid"], ["seg", 4, "softmax"]]
HCFG = dict(CFG, HEADS=HEADS, GAUS=True, SIGMA=1, MONITOR_LOCALISATION=False)


def _head_labels(rng, n, h, w):
    """[n, 2, h, w]: RVIP labels {0, 1, 2} and ventricle labels {0..3}."""
    seg = rng.integers(0, 4, (n, h, w)).astype(np.float32)
    return np.stack([_labels(rng, n, h, w), seg], axis=1)


@pytest.mark.parametrize("gaus", [True, False], ids=["heatmaps", "binary"])
def test_finalize_heads_matches_cmrtpu(gaus):
    cfg = dict(HCFG, GAUS=gaus)
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(5, 24, 28)).astype(np.float32)
    msks = _head_labels(rng, 5, 24, 28)
    ref_x, ref_y = jax_finalize(jnp.asarray(imgs), jnp.asarray(msks), cfg)
    x, y = finalize_batch(torch.from_numpy(imgs), torch.from_numpy(msks), cfg)
    ref_y = np.asarray(ref_y)
    assert y.shape == ref_y.shape == (5, 24, 28, 6)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=1e-5)
    np.testing.assert_array_equal(y[..., 2:].numpy(), ref_y[..., 2:])
    if gaus:
        np.testing.assert_allclose(y[..., :2].numpy(), ref_y[..., :2],
                                   atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(y[..., :2].numpy(), ref_y[..., :2])


def test_multi_head_loss_and_forward_match_cmrtpu():
    cfg = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 8, "MASK_CLASSES": 2,
           "MIXED_PRECISION": False, "BATCH_NORMALISATION": True,
           "HEADS": HEADS, "HEAD_BIAS_PRIOR": 0.05}
    variables = perturbed_variables(cfg, 3)
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 1)).astype(
        np.float32)
    ref = jax_build_model(cfg).apply(variables, x, train=False)
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert set(got) == set(ref) == {"rvip", "seg"}
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(got["seg"].sum(-1).numpy(), 1.0, atol=1e-5)

    rng = np.random.default_rng(5)
    _, y = finalize_batch(torch.zeros(3, 32, 32),
                          torch.from_numpy(_head_labels(rng, 3, 32, 32)),
                          dict(HCFG))
    want = float(jl.multi_head_loss(HEADS)(
        jnp.asarray(y.numpy()), {k: jnp.asarray(v.numpy())
                                 for k, v in got.items()}))
    assert float(tl.get_loss({"HEADS": HEADS})(y, got)) == pytest.approx(
        want, rel=1e-5)
    concat = tl.concat_heads(HEADS)(got)
    np.testing.assert_array_equal(concat.numpy(), np.asarray(jl.concat_heads(
        HEADS)({k: jnp.asarray(v.numpy()) for k, v in got.items()})))


def test_reset_parameters_heads():
    cfg = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MIXED_PRECISION": False,
           "HEADS": HEADS, "HEAD_BIAS_PRIOR": 0.01}
    model = build_model(cfg).reset_parameters(torch.Generator().manual_seed(1))
    assert model.head_rvip.bias.detach().numpy() == pytest.approx(
        np.log(0.01 / 0.99), rel=1e-6)
    assert not model.head_seg.bias.detach().any()  # softmax: no prior
    assert not hasattr(model, "head")


@pytest.mark.parametrize("rules", [None, [["nomatch", "x"], ["msk", "seg"]]],
                         ids=["default-rules", "explicit-rules"])
def test_generator_head_sources_match_cmrtpu(rules, tmp_path):
    # 'msk' in the directory name must not be rewritten
    two_d = tmp_path / "cohort_msk" / "2D"
    two_d.mkdir(parents=True)
    rng = np.random.default_rng(7)
    xs, ys = [], []
    for z in range(3):
        stem = str(two_d / f"patient001__t01_z{z}")
        labels = _head_labels(rng, 1, 20, 26)[0]
        for suffix, arr in (("img", rng.normal(size=(20, 26)).astype(
                np.float32)), ("msk", labels[0].astype(np.uint8)),
                ("seg", labels[1].astype(np.uint8))):
            write_image(MedicalImage(array=arr, spacing=(1.3, 1.3)),
                        f"{stem}_{suffix}.nrrd")
        xs.append(f"{stem}_img.nrrd")
        ys.append(f"{stem}_msk.nrrd")
    cfg = dict(HCFG, DIM=[24, 24], HEAD_MASK_RULES=rules, SPACING=[1.1, 1.1])
    ref = JaxGenerator(xs, ys, config=cfg)
    got = DataGenerator(xs, ys, config=cfg)
    assert got._cache_y.shape == (3, 2, 24, 24)
    np.testing.assert_array_equal(got._cache_y, ref._cache_y)
    np.testing.assert_array_equal(got._cache_x, ref._cache_x)
    assert set(np.unique(got._cache_y[:, 1])) <= {0, 1, 2, 3}


@pytest.mark.parametrize("mode", [0, 4])
def test_augment_warps_every_head(mode, monkeypatch):
    rng = np.random.default_rng(mode)
    imgs = rng.random((6, 32, 32)).astype(np.float32)
    msks = rng.integers(0, 4, (6, 2, 32, 32)).astype(np.float32)
    params = _params(seed=20 + mode, mode=mode, square=True)
    ref_i, ref_m = _jax_augment(params, imgs, msks, monkeypatch)
    tp = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray)
          else v for k, v in params.items() if k != "gd_key"}
    tp["rot_k"] = tp["rot_k"].long()
    got_i, got_m = apply_params(tp, torch.from_numpy(imgs),
                                torch.from_numpy(msks))
    assert got_m.shape == msks.shape
    np.testing.assert_allclose(got_i.numpy(), ref_i, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_m.numpy(), ref_m)


def test_head_outputs_match_cmrtpu():
    rng = np.random.default_rng(8)
    preds = {"rvip": rng.random((3, 16, 16, 2)).astype(np.float32),
             "seg": rng.dirichlet(np.ones(4), (3, 16, 16)).astype(np.float32)}
    _, gts = finalize_batch(torch.zeros(3, 16, 16), torch.from_numpy(
        _head_labels(rng, 3, 16, 16)), dict(HCFG, GAUS=False))
    gts = gts.numpy()
    cfgs = [dict(HCFG), dict(HCFG, HEADS=[["seg", 4, "softmax"],
                                          ["rvip", 2, "sigmoid"]]),
            {"HEADS": [["seg", 4, "softmax"]]}, {}]
    for cfg in cfgs:
        heads = cfg.get("HEADS")
        p = preds if heads else preds["rvip"]
        g = gts if heads else gts[..., :2]
        if heads == [["seg", 4, "softmax"]]:
            p, g = {"seg": preds["seg"]}, gts[..., 2:]
        for truth in (g, None):
            ref = jax_predictor._head_outputs(cfg, p, truth)
            got = port_predictor._head_outputs(cfg, p, truth)
            assert [r[0] for r in got] == [r[0] for r in ref]
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a[1], b[1])
                assert (a[2] is None) == (b[2] is None)
                if a[2] is not None:
                    np.testing.assert_array_equal(a[2], b[2])
                assert a[3] == b[3]
        served = port_serving._flat_pred_heads(cfg, p)
        want = jax_serving._flat_pred_heads(cfg, p)
        assert [(s, v) for s, _, v in served] == [(s, v) for s, _, v in want]
        for a, b in zip(served, want):
            np.testing.assert_array_equal(a[1], b[1])


def test_heads_train_step_matches_cmrtpu():
    cfg = dict(HCFG, BATCHSIZE=8, ACTIVATION="elu", GROUP_NORM=0,
               BATCH_NORMALISATION=True, LEARNING_RATE=1e-3)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = _head_labels(rng, 8, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg, jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables))
    mesh = create_mesh(devices=jax.devices()[:1])
    optimizer = jax_get_optimizer(cfg)
    concat = jl.concat_heads(HEADS)  # as cmrtpu's Trainer wraps them
    metrics = {name: (lambda yt, yp, f=fn: f(yt, concat(yp)))
               for name, fn in jl.default_metrics(2).items()}
    step = make_cached_train_step(model, optimizer, jl.get_loss(cfg),
                                  metrics, cfg, mesh, augment=False)
    state = S.create_train_state(model, variables, optimizer)
    dx, dy = upload_cache(xs, ys, mesh)
    _, ref_logs = step(state, dx, dy, jnp.arange(8, dtype=jnp.int32),
                       jax.random.key(0))

    port = build_model(cfg)
    port.load_state_dict(flax_to_state_dict(init["params"],
                                            init["batch_stats"]))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    logs = DeviceCachedLoop(trainer, gen).train_step(torch.arange(8))
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
