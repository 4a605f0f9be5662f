"""cmrtpu_torch's training slice against cmrtpu on the CPU.

* ``finalize_batch`` on the same seeded batch (targets within 1e-5: the
  same float32 arithmetic, blur sums in another order).
* One fused train step from the same ``init_variables`` weights, f32,
  dropout 0, AUGMENT off, against cmrtpu's ``make_cached_train_step`` run
  with an identity optimizer (so its update is the gradient): loss and
  metrics within rel 1e-5, each gradient within 1e-3 x its max |value|, and
  the port's Adam update against optax's adam on those gradients. The step
  uses ELU: with ReLU the float32 gradient of this GroupNorm U-Net at a
  random init is ill-conditioned (torch's and cmrtpu's f32 gradients each
  lie 1-5% of max |g| from a float64 evaluation, PERF.md), so no f32 pair
  can agree to 1e-3; with ELU both lie within 5e-4 of it.
* ``run_experiment`` of both packages on one tiny written dataset for 2
  epochs, AUGMENT off, dropout 0, f32, the port starting from cmrtpu's
  initial weights: history.csv columns equal and values within rel 1e-4, and
  each package loads the other's model.npz.
* Every config key the port does not train with raises (BatchNorm,
  HEADS and histogram matching train: tests/test_torch_{batchnorm,heads,
  histmatch}.py; the optimizers, AGC, EMA, cache dtypes, RESUME and the
  LR schedules: tests/test_torch_{optimizers,ema,cache_dtype,resume,
  callbacks}.py; the sharded cache, the explicit-collectives step and
  host streaming: tests/test_torch_{sharded_cache,streaming}.py).
"""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cmrtpu.train.trainer as jax_trainer
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.pipeline.generator import finalize_batch as jax_finalize
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu.train import steps as S
from cmrtpu.train.device_cache import make_cached_train_step, upload_cache
from cmrtpu.train.fold import run_experiment as jax_run_experiment
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu_torch.cli.train import main as train_main
from cmrtpu_torch.data.dataset import slice_file_name
from cmrtpu_torch.io import MedicalImage, write_image
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.pipeline.generator import finalize_batch
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train import trainer as port_trainer
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           load_weights_for_model)
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.fold import run_experiment
from cmrtpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CFG = {"EXPERIMENT": "torch_train", "DIM": [32, 32], "DEPTH": 2,
       "FILTERS": 4, "MASK_CLASSES": 2, "MASK_VALUES": [1, 2],
       "GROUP_NORM": 4, "MIXED_PRECISION": False, "DROPOUT_MIN": 0.0,
       "DROPOUT_MAX": 0.0, "AUGMENT": False, "GAUS": True, "SIGMA": 1,
       "SPACING": [1.0, 1.0], "RESAMPLE": True, "BATCHSIZE": 4, "SEED": 7,
       "LOSS_FUNCTION": "BcdDiceLoss", "MONITOR_LOCALISATION": True,
       "MONITOR_FUNCTION": "val_loss", "SAVE_MODEL_FUNCTION": "val_loc_mm",
       "FOLDS": [0], "EPOCHS": 2, "GENERATOR_WORKER": 2,
       "SAVE_LEARNING_PROGRESS_AS_TF": False}


def _labels(rng, n, h, w):
    msks = np.zeros((n, h, w), np.float32)
    for i in range(n):
        if i % 4 == 3:
            continue  # a slice with no landmark
        y, x = rng.integers(4, h - 8), rng.integers(4, w - 8)
        msks[i, y:y + 2, x:x + 2] = 1
        msks[i, y + 4:y + 6, x + 3:x + 5] = 2
    return msks


@pytest.mark.parametrize("extra,masks", [
    ({}, True),
    ({"GAUS": False}, True),
    ({"SIGMA": 2, "SCALER": "Standard"}, True),
    ({"SCALER": "Robust"}, True),
    ({}, False),
], ids=["gaus-minmax", "binary", "gaus2-standard", "robust", "no-masks"])
def test_finalize_batch_matches_cmrtpu(extra, masks):
    cfg = {**CFG, **extra}
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(5, 24, 28)).astype(np.float32)
    msks = _labels(rng, 5, 24, 28) if masks else \
        rng.normal(size=(5, 24, 28)).astype(np.float32)
    ref_x, ref_y = jax_finalize(jnp.asarray(imgs), jnp.asarray(msks), cfg,
                                masks=masks)
    x, y = finalize_batch(torch.from_numpy(imgs), torch.from_numpy(msks),
                          cfg, masks=masks)
    assert x.shape == ref_x.shape and y.shape == ref_y.shape
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5)


def test_train_step_matches_cmrtpu():
    cfg = dict(CFG, BATCHSIZE=8, ACTIVATION="elu")
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = _labels(rng, 8, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg, jax.random.PRNGKey(3))
    mesh = create_mesh(devices=jax.devices()[:1])
    identity = optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params=None: (grads, state))
    metrics = jax_default_metrics(2)
    from cmrtpu.eval.detection import localisation_metrics as jax_loc
    metrics.update(jax_loc(cfg))
    step = make_cached_train_step(model, identity, jax_get_loss(cfg),
                                  metrics, cfg, mesh, augment=False)
    # the fused step donates its state: init_tree keeps numpy copies
    init_tree = jax.tree_util.tree_map(np.array, dict(variables["params"]))
    state = S.create_train_state(model, variables, identity)
    dx, dy = upload_cache(xs, ys, mesh)
    new_state, ref_logs = step(state, dx, dy, jnp.arange(8, dtype=jnp.int32),
                               jax.random.key(0))
    ref_grads = jax.tree_util.tree_map(lambda new, old: np.array(new) - old,
                                       dict(new_state.params), init_tree)

    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init_tree))
    trainer = Trainer(cfg, model=port, device="cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    loop = DeviceCachedLoop(trainer, gen)
    logs = loop.train_step(torch.arange(8))

    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
    grads = flax_to_state_dict(ref_grads)
    adam = optax.adam(1e-4, eps=1e-8)
    for name, p in port.named_parameters():
        g_ref = grads[name].numpy()
        scale = np.abs(g_ref).max()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
        # Adam's first step is lr * g / (|g| + eps): compare it where the
        # gradient is clear of zero, where its sign cannot differ; torch
        # forms the bias corrections in float64 on the host and optax in
        # float32, 2e-4 apart at step 1
        upd, _ = adam.update(jnp.asarray(g_ref), adam.init(jnp.asarray(g_ref)))
        moved = p.detach().numpy() - before[name].numpy()
        clear = np.abs(g_ref) > 1e-3 * scale
        np.testing.assert_allclose(moved[clear], np.asarray(upd)[clear],
                                   rtol=1e-3, atol=1e-9, err_msg=name)
    assert trainer.state.step == 1


def _write_dataset(root, patients=5, slices=3, shape=(36, 40)):
    """2D slices of ``patients`` patients (one frame each) plus a
    df_kfold.csv: fold 0 trains on the first three and validates on the
    rest, so with BATCHSIZE 4 the val set ends in a remainder batch."""
    rng = np.random.default_rng(5)
    two_d = os.path.join(root, "2D")
    os.makedirs(two_d)
    rows = []
    for i in range(patients):
        patient = f"patient{i:03d}"
        msks = _labels(rng, slices, *shape)
        for z in range(slices):
            img = rng.normal(300.0, 60.0, shape).astype(np.float32)
            img += 400.0 * (msks[z] > 0)
            for kind, arr in (("img", img), ("msk", msks[z].astype(np.uint8))):
                write_image(MedicalImage(array=arr, spacing=(1.25, 1.25)),
                            os.path.join(two_d, slice_file_name(
                                patient, "01", z, kind)))
        modality = "train" if i < 3 else "test"
        rows.append({"fold": 0, "x_path": "", "y_path": "",
                     "modality": modality, "patient": patient})
    with open(os.path.join(root, "df_kfold.csv"), "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return root


def _history(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_run_experiment_matches_cmrtpu(tmp_path, monkeypatch):
    # a head bias prior of 1e-3 keeps every probability far below the 0.5
    # detection threshold through 2 epochs, so loc_mm / loc_det / loc_fp
    # are exact in both packages (detection itself is held against cmrtpu
    # in test_torch_losses_detection.py)
    cfg = dict(CFG, HEAD_BIAS_PRIOR=0.001)
    data = _write_dataset(str(tmp_path / "data"))
    captured = {}

    def capture(model, config, rng):
        variables = init_variables(model, config, rng)
        # numpy copies: cmrtpu's fused step donates the state it starts from
        captured["params"] = jax.tree_util.tree_map(
            np.array, dict(variables["params"]))
        return variables

    monkeypatch.setattr(jax_trainer, "init_variables", capture)
    jax_exp = jax_run_experiment(dict(cfg), data_path=data,
                                 exp_path=str(tmp_path / "jax"))

    def from_cmrtpu(config, supervision=False):
        model = get_model(config, supervision=supervision)
        model.load_state_dict(flax_to_state_dict(captured["params"]))
        return model

    monkeypatch.setattr(port_trainer, "init_model", from_cmrtpu)
    torch_exp = run_experiment(dict(cfg), data_path=data,
                               exp_path=str(tmp_path / "torch"),
                               device="cpu")

    ref = _history(os.path.join(jax_exp, "f0", "history.csv"))
    got = _history(os.path.join(torch_exp, "f0", "history.csv"))
    assert len(got) == len(ref) == 2
    assert list(got[0]) == list(ref[0])
    for r, g in zip(ref, got):
        for key in r:
            if key == "epoch_time":  # wall clock
                continue
            assert float(g[key]) == pytest.approx(float(r[key]), rel=1e-4,
                                                  abs=1e-6), key

    x = np.random.default_rng(9).normal(size=(3, 32, 32, 1)).astype(np.float32)
    jax_model = jax_build_model(cfg)
    # the port's model.npz in cmrtpu, against the port's own forward of it
    params, stats = jax_ckpt.load_weights(
        os.path.join(torch_exp, "f0", "model"))
    in_jax = np.asarray(jax_model.apply({"params": params, **(
        {"batch_stats": stats} if stats else {})}, x, train=False))
    own = get_model(cfg)
    load_weights_for_model(os.path.join(torch_exp, "f0", "model"), own,
                           cfg)
    with torch.no_grad():
        np.testing.assert_allclose(
            own.eval()(torch.from_numpy(x)).numpy(), in_jax, atol=1e-4)
    # cmrtpu's model.npz in the port's serving Predictor
    params, _ = jax_ckpt.load_weights(os.path.join(jax_exp, "f0", "model"))
    want = np.asarray(jax_model.apply({"params": params}, x, train=False))
    pred = Predictor(cfg, os.path.join(jax_exp, "f0", "model"), device="cpu")
    np.testing.assert_allclose(pred.predict(x), want, atol=1e-4)
    for name in ("model_summary.txt", "fold_complete.json",
                 "config/config.json"):
        assert os.path.exists(os.path.join(torch_exp, "f0", name)), name
    assert os.listdir(os.path.join(torch_exp, "f0", "tensorboard_logs"))


def test_cli_trains_on_cpu(tmp_path):
    data = _write_dataset(str(tmp_path / "data"))
    cfg = dict(CFG, EPOCHS=1, AUGMENT=True, RANDOMROTATE=True,
               SHIFTSCALEROTATE=True, GRIDDISTORTION=True,
               DROPOUT_MIN=0.3, DROPOUT_MAX=0.5,
               EXPERIMENTS_ROOT=str(tmp_path / "exp"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(__import__("json").dumps(cfg))
    exp = train_main(["-cfg", str(cfg_path), "-data", data, "--device",
                      "cpu"])
    rows = _history(os.path.join(exp, "f0", "history.csv"))
    assert len(rows) == 1
    assert all(np.isfinite(float(rows[0][k]))
               for k in ("loss", "val_loss", "val_loc_mm"))
    assert os.path.exists(os.path.join(exp, "f0", "model", "model.npz"))


def test_device_default_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG)


@pytest.mark.parametrize("extra,error", [
    ({"LOSS_FUNCTION": "focal"}, NotImplementedError),
    # the 3D U-Net trains (tests/test_torch_cine.py); MONITOR_LOCALISATION
    # covers 2D only, as in cmrtpu
    ({"DIM": [8, 32, 32]}, ValueError),
    ({"PAD": "valid"}, NotImplementedError),
    ({"KERNEL_INIT": "glorot_uniform"}, NotImplementedError),
    ({"QUANT_INT8": True}, ValueError),
], ids=["loss", "3d", "pad", "kernel-init", "int8"])
def test_unsupported_trainer_keys_raise(extra, error):
    with pytest.raises(error):
        Trainer({**CFG, **extra}, device="cpu")

