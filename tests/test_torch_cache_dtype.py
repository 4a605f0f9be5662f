"""cmrtpu_torch's cache dtypes (CACHE_DTYPE) against cmrtpu on the CPU.

* The packed cache equals cmrtpu's ``_pack_arrays`` bit for bit: bfloat16
  images (round to nearest even in both: torch's cast and ml_dtypes'),
  per-example uint8 images (``quantize_images_uint8``), uint8 masks.
* The two uint8 warnings, and ``fits_device_cache`` on packed bytes.
* One train step from a bf16 and from a uint8 cache against cmrtpu's
  fused step on the same packed cache: loss and metrics within rel 1e-5
  (the gathered rows are the same float32 values in both).
"""

import logging
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.train import device_cache as JD
from cmrtpu.train import steps as S
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.train import device_cache as D
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG, _labels

torch.set_num_threads(1)


def _images(rng, n=6, h=20, w=24):
    """Scanner-like intensities plus the values where rounding is hard:
    bf16 ties, subnormals, zeros, a constant slice."""
    x = rng.normal(300.0, 80.0, (n, h, w)).astype(np.float32)
    x[0, 0, :8] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 1e-40,
                   -1e-39, 3.3895314e38, 65504.0, 2.0 ** -126]
    x[1] = 7.0  # constant: span clamps to float32's tiny
    x[2, :, :4] = 0.0  # pad zeros
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bf16", "uint8",
                                   "u8"])
def test_pack_equals_cmrtpu(dtype):
    rng = np.random.default_rng(0)
    x, y = _images(rng), _labels(rng, 6, 20, 24)
    cfg = {"CACHE_DTYPE": dtype}
    want_x, want_y = JD._pack_arrays(x, y, cfg)
    got_x, got_y = D.pack_arrays(x, y, cfg)
    assert want_y.dtype == np.uint8 and np.array_equal(got_y.numpy(), want_y)
    if want_x.dtype == ml_dtypes.bfloat16:
        assert got_x.dtype == torch.bfloat16
        np.testing.assert_array_equal(got_x.view(torch.int16).numpy(),
                                      want_x.view(np.int16))
    else:
        assert got_x.numpy().dtype == want_x.dtype
        np.testing.assert_array_equal(got_x.numpy(), want_x)
    assert D._packed_nbytes(cfg, x, y) == JD._packed_nbytes(cfg, x, y) == \
        got_x.element_size() * got_x.numel() + got_y.numel()


def test_float_labels_stay_float():
    rng = np.random.default_rng(1)
    x, y = _images(rng), rng.normal(size=(6, 20, 24)).astype(np.float32)
    got_x, got_y = D.pack_arrays(x, y, {"CACHE_DTYPE": "uint8"})
    assert got_y.dtype == torch.float32
    assert D._packed_nbytes({"CACHE_DTYPE": "uint8"}, x, y) == \
        JD._packed_nbytes({"CACHE_DTYPE": "uint8"}, x, y) == x.size + y.nbytes


@pytest.mark.parametrize("cfg", [
    {"BORDER_MODE": 0, "BORDER_VALUE": 5},
    {"HIST_MATCHING": True, "SCALER": "Standard"},
    {"BORDER_MODE": 0, "BORDER_VALUE": 0},
    {"BORDER_MODE": None, "BORDER_VALUE": 3},
], ids=["constant-border", "standard-histmatch", "zero-border", "default"])
def test_uint8_warnings_equal_cmrtpu(cfg, caplog):
    with caplog.at_level(logging.WARNING):
        JD._warn_if_uint8_unsafe(cfg, "CACHE_DTYPE")
        want = [r.getMessage() for r in caplog.records]
        caplog.clear()
        D._warn_if_uint8_unsafe(cfg, "CACHE_DTYPE")
        got = [r.getMessage() for r in caplog.records]
    assert got == want
    assert len(got) == (0 if cfg.get("BORDER_VALUE") in (0, 3) else 1)


@pytest.mark.parametrize("dtype,fits", [("float32", False),
                                        ("bfloat16", True), ("uint8", True)])
def test_fits_device_cache_on_packed_bytes(dtype, fits):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 32, 32)).astype(np.float32)
    y = _labels(rng, 64, 32, 32)
    # room for bf16 images and uint8 masks, not for float32 images
    limit = (2 * x.size + y.size + 1024) / (1 << 30)
    cfg = {"CACHE_DTYPE": dtype, "DEVICE_CACHE_LIMIT_GB": limit}
    assert D.fits_device_cache(cfg, x, y) is JD.fits_device_cache(cfg, x, y) \
        is fits


@pytest.mark.parametrize("dtype", ["bfloat16", "uint8"])
def test_train_step_from_packed_cache_matches_cmrtpu(dtype):
    cfg = dict(CFG, BATCHSIZE=8, ACTIVATION="elu", CACHE_DTYPE=dtype,
               MONITOR_LOCALISATION=False)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = _labels(rng, 8, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg,
                               jax.random.key(4, impl="threefry2x32"))
    init_tree = jax.tree_util.tree_map(np.array, dict(variables["params"]))
    mesh = create_mesh(devices=jax.devices()[:1])
    identity = optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params=None: (grads, state))
    step = JD.make_cached_train_step(model, identity, jax_get_loss(cfg),
                                     jax_default_metrics(2), cfg, mesh,
                                     augment=False)
    dx, dy = JD.upload_cache(xs, ys, mesh, config=cfg)
    _, ref_logs = step(S.create_train_state(model, variables, identity), dx,
                       dy, jnp.arange(8, dtype=jnp.int32), jax.random.key(0))

    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init_tree))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    loop = D.DeviceCachedLoop(trainer, gen)
    assert loop.x_train.dtype == {"bfloat16": torch.bfloat16,
                                  "uint8": torch.uint8}[dtype]
    assert loop.y_train.dtype == torch.uint8
    imgs, _ = loop._gather(loop.x_train, loop.y_train, torch.arange(8))
    assert imgs.dtype == torch.float32
    logs = loop.train_step(torch.arange(8))
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
