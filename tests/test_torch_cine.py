"""cmrtpu_torch's 3D cine path (``cine_3d_config.json``: a [T, H, W] U-Net
over temporal SAX stacks) against cmrtpu on the CPU, at [4, 16, 16] to
[4, 32, 32], depth <= 3, 4 filters.

* The 3D forward against ``model.apply`` on bridged weights: GroupNorm,
  BatchNorm in eval and in train mode (with the running averages it moves),
  no norm, both decoders, and pools clamped where t runs out (t=4,
  M_POOL [2, 2, 2], depth 3). Probabilities within 1e-4 in f32 (sums in
  another order), 2e-2 under MIXED_PRECISION (bf16 rounds at other places).
* ``model.npz`` with 5D kernels, both decoders, both ways, bit for bit; the
  he_normal fan-in of ``Conv3d`` and ``ConvTranspose3d`` kernels.
* Augmentation of [B, T, H, W] with cmrtpu's draws injected (images 1e-5,
  masks exact), one warp for every frame of an example and every head.
* ``finalize_batch`` on volumes with GAUS within 1e-6 (the same float32
  taps, summed in another order), the in-plane RESAMPLE of
  ``DataGenerator`` equal to cmrtpu's, and the binned histogram matcher on
  whole volumes within 1e-6.
* One cached train step from cmrtpu's weights (f32, ELU, dropout 0,
  AUGMENT off; GroupNorm, BatchNorm, and two HEADS) against
  ``make_cached_train_step``: loss and metrics within rel 1e-5, gradients
  within 1e-3 x max |g|, running averages within 1e-5.
* ``fit_cached`` on written cine files: the loss decreases
  (tests/test_cine.py); ``Trainer.predict`` and the restored ``Predictor``
  against ``model.apply``.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmrtpu.models.hybrids import get_model as jax_get_model
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.pipeline.generator import DataGenerator as JaxDataGenerator
from cmrtpu.pipeline.generator import finalize_batch as jax_finalize
from cmrtpu.pipeline.histmatch import match_histograms_binned_jax
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu.train import steps as S
from cmrtpu.train.device_cache import make_cached_train_step, upload_cache
from cmrtpu.train.losses import concat_heads as jax_concat_heads
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu_torch.io import MedicalImage, write_image
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.pipeline.augment import apply_params
from cmrtpu_torch.pipeline.generator import DataGenerator, finalize_batch
from cmrtpu_torch.pipeline.histmatch import match_histograms_binned
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           load_weights_for_model,
                                           save_weights, state_dict_to_flax)
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_augment import B, _jax_augment, _params
from test_torch_batchnorm import _flat
from test_torch_checkpoint import _assert_same_npz, _npz, _random_stats
from test_torch_unet import forward_both, perturbed_variables

torch.set_num_threads(1)

T_FRAMES = 4
CINE = {"DIM": [T_FRAMES, 16, 16], "F_SIZE": [3, 3, 3], "M_POOL": [1, 2, 2],
        "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2, "MASK_VALUES": [1, 2],
        "MIXED_PRECISION": False, "DROPOUT_MIN": 0.0, "DROPOUT_MAX": 0.0,
        "AUGMENT": False, "GAUS": True, "SIGMA": 1, "BATCHSIZE": 4,
        "SEED": 7, "LOSS_FUNCTION": "BcdDiceLoss", "RESAMPLE": False}
GN = dict(CINE, GROUP_NORM=4)
BN = dict(CINE, BATCH_NORMALISATION=True)
CLAMPED = dict(GN, M_POOL=[2, 2, 2], DEPTH=3, GROUP_NORM=2)
PROB_ATOL, BF16_ATOL = 1e-4, 2e-2


def _cine_labels(rng, n, t, h, w):
    """[n, t, h, w] label maps: two 2x2 landmarks per example that drift
    by a pixel over t; every fourth example has none."""
    msks = np.zeros((n, t, h, w), np.float32)
    for i in range(n):
        if i % 4 == 3:
            continue
        y, x = rng.integers(3, h - 8), rng.integers(3, w - 8)
        for k in range(t):
            d = k % 2
            msks[i, k, y + d:y + d + 2, x:x + 2] = 1
            msks[i, k, y + 4:y + 6, x + 3 + d:x + 5 + d] = 2
    return msks


@pytest.mark.parametrize("cfg", [
    GN, BN, dict(BN, BN_FIRST=True, ACTIVATION="elu"),
    dict(BN, USE_UPSAMPLE=False), CLAMPED,
    dict(CINE, BATCH_NORMALISATION=False, DIM=[T_FRAMES, 24, 20]),
], ids=["gn", "bn", "bn-first-elu", "transpose-bn", "clamped-pools",
        "no-norm-oblong"])
def test_forward_3d_matches_flax_f32(cfg):
    ref, got = forward_both(cfg, batch=2)
    assert got.shape == ref.shape == (2, *cfg["DIM"], 2)
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("cfg", [GN, BN], ids=["gn", "bn"])
def test_forward_3d_matches_flax_mixed_precision(cfg):
    # conv biases at their zero init, as tests/test_torch_unet.py explains
    ref, got = forward_both(dict(cfg, MIXED_PRECISION=True), batch=2,
                            conv_bias=False)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=0)


def test_clamped_pools_warn_and_mirror():
    """t=4 with M_POOL [2, 2, 2] at depth 3 runs out at the third level:
    the encoder keeps t there and the decoder mirrors the factors."""
    model = build_model(CLAMPED).reset_parameters(
        torch.Generator().manual_seed(0))
    with pytest.warns(UserWarning, match=r"\(1, 2, 2\)"):
        out = model.eval()(torch.zeros(1, *CLAMPED["DIM"], 1))
    assert out.shape == (1, *CLAMPED["DIM"], 2)


def test_bn_train_forward_matches_flax():
    """Train-mode BatchNorm over N, T, H, W: the output and the running
    averages flax moves."""
    variables = perturbed_variables(BN, 4)
    x = np.random.default_rng(4).standard_normal(
        (3, *BN["DIM"], 1)).astype(np.float32)
    ref, moved = jax_build_model(BN).apply(
        variables, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(0, impl="threefry2x32")})
    model = build_model(BN)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    got = model.train()(torch.from_numpy(x),
                        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=PROB_ATOL, rtol=0)
    _, stats = state_dict_to_flax(model.state_dict())
    want = _flat(moved["batch_stats"])
    for name, value in _flat(stats).items():
        np.testing.assert_allclose(value, want[name], atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("cfg", [BN, dict(GN, USE_UPSAMPLE=False)],
                         ids=["bn-upsample", "gn-transpose"])
def test_npz_5d_round_trips_both_ways(cfg, tmp_path):
    variables = init_variables(jax_build_model(cfg), cfg,
                               jax.random.key(3, impl="threefry2x32"))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(
            np.float32), dict(variables))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_ckpt.save_weights(a, variables["params"],
                          variables.get("batch_stats"))
    model = load_weights_for_model(a, build_model(cfg), cfg)
    assert any(t.dim() == 5 for t in model.state_dict().values())
    save_weights(b, model)
    _assert_same_npz(_npz(a), _npz(b))

    # the port's npz in cmrtpu: written back unchanged, the same forward
    port = _random_stats(
        build_model(cfg).reset_parameters(torch.Generator().manual_seed(5)),
        seed=5)
    c, d = str(tmp_path / "c"), str(tmp_path / "d")
    save_weights(c, port)
    params, stats = jax_ckpt.load_weights(c)
    jax_ckpt.save_weights(d, params, stats)
    _assert_same_npz(_npz(c), _npz(d))
    x = np.random.default_rng(0).standard_normal(
        (1, *cfg["DIM"], 1)).astype(np.float32)
    want = np.asarray(jax_build_model(cfg).apply(
        {"params": params, **({"batch_stats": stats} if stats else {})},
        x, train=False))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


def test_state_dict_to_flax_rejects_foreign_entries():
    with pytest.raises(ValueError, match="no flax counterpart"):
        state_dict_to_flax({"ConvBlock_0.GroupNorm_0.weight":
                            torch.zeros(3, 3, 3, 3, 3)})
    with pytest.raises(ValueError, match="no flax counterpart"):
        state_dict_to_flax({"ConvBlock_0.Conv_0.weight": torch.zeros(4, 2)})
    with pytest.raises(ValueError, match="not a leaf"):
        flax_to_state_dict({"ConvBlock_0": {"Conv_0": {
            "kernel": np.zeros((3, 3, 3, 3, 1, 4), np.float32)}}})


def test_he_normal_fan_in_of_5d_kernels():
    model = build_model(dict(GN, FILTERS=8, USE_UPSAMPLE=False))
    model.reset_parameters(torch.Generator().manual_seed(1))
    conv = model.get_submodule("DownBlock_1.ConvBlock_0.Conv_0")
    up = model.get_submodule("UpBlock_0.ConvTranspose_0")
    assert isinstance(conv, torch.nn.Conv3d)
    assert isinstance(up, torch.nn.ConvTranspose3d)
    for w, fan_in in ((conv.weight, conv.weight[0].numel()),
                      (up.weight, up.weight[:, 0].numel())):
        std = np.sqrt(2.0 / fan_in)
        assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7
        assert w.std().item() == pytest.approx(std, rel=0.1)
    assert not conv.bias.any() and not up.bias.any()


def _volumes(seed, t=T_FRAMES, h=24, w=24):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, t, h, w)).astype(np.float32)
    msks = rng.integers(0, 3, (B, t, h, w)).astype(np.float32)
    return imgs, msks


def _torch_params(params):
    tp = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray)
          else v for k, v in params.items() if k != "gd_key"}
    tp["rot_k"] = tp["rot_k"].long()
    return tp


@pytest.mark.parametrize("mode", [0, 4])
@pytest.mark.parametrize("shape", [(24, 24), (20, 28)],
                         ids=["square", "oblong"])
def test_augment_volumes_match_cmrtpu(mode, shape, monkeypatch):
    imgs, msks = _volumes(mode, h=shape[0], w=shape[1])
    params = _params(seed=20 + mode, mode=mode, square=shape[0] == shape[1])
    ref_i, ref_m = _jax_augment(params, imgs, msks, monkeypatch)
    got_i, got_m = apply_params(_torch_params(params), torch.from_numpy(imgs),
                                torch.from_numpy(msks))
    assert got_i.shape == imgs.shape and got_m.shape == msks.shape
    np.testing.assert_allclose(got_i.numpy(), ref_i, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_m.numpy(), ref_m)


def test_augment_one_warp_for_every_frame_and_head():
    """Identical frames stay identical after the warp (tests/test_cine.py);
    a head axis before T gets the same warp as the single mask."""
    imgs, msks = _volumes(1)
    imgs = np.repeat(imgs[:, :1], T_FRAMES, axis=1)
    params = _torch_params(_params(seed=5, mode=4, square=True))
    out_i, out_m = apply_params(params, torch.from_numpy(imgs),
                                torch.from_numpy(msks))
    for t in range(1, T_FRAMES):
        torch.testing.assert_close(out_i[:, t], out_i[:, 0], atol=0, rtol=0)
    heads = torch.from_numpy(np.stack([msks, msks[:, ::-1].copy()], axis=1))
    _, out_h = apply_params(params, torch.from_numpy(imgs), heads)
    torch.testing.assert_close(out_h[:, 0], out_m, atol=0, rtol=0)
    _, flipped = apply_params(params, torch.from_numpy(imgs),
                              heads[:, 1].contiguous())
    torch.testing.assert_close(out_h[:, 1], flipped, atol=0, rtol=0)


@pytest.mark.parametrize("extra", [{}, {"SIGMA": 2}, {"GAUS": False}],
                         ids=["gaus1", "gaus2", "binary"])
def test_finalize_volumes_matches_cmrtpu(extra):
    cfg = dict(CINE, **extra)
    rng = np.random.default_rng(11)
    imgs = rng.normal(size=(4, T_FRAMES, 20, 24)).astype(np.float32)
    msks = _cine_labels(rng, 4, T_FRAMES, 20, 24)
    ref_x, ref_y = jax_finalize(jnp.asarray(imgs), jnp.asarray(msks), cfg)
    x, y = finalize_batch(torch.from_numpy(imgs), torch.from_numpy(msks), cfg)
    assert y.shape == ref_y.shape == (4, T_FRAMES, 20, 24, 2)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-6)
    assert not y[3].any()  # the example with no landmark stays zero


def test_hist_match_volumes_matches_cmrtpu():
    """HIST_MATCHING on a cine cache matches whole [T, H, W] volumes, as
    cmrtpu's matcher vmapped over examples does."""
    rng = np.random.default_rng(6)
    src = rng.random((3, T_FRAMES, 20, 20)).astype(np.float32) ** 1.5
    ref = rng.random((3, T_FRAMES, 20, 20)).astype(np.float32)
    src[:, :, :2] = 0.0  # a padded border the matcher excludes
    want = jax.vmap(lambda s, r: match_histograms_binned_jax(
        s, r, bins=2048, exclude_zeros=True))(jnp.asarray(src),
                                              jnp.asarray(ref))
    got = match_histograms_binned(torch.from_numpy(src),
                                  torch.from_numpy(ref), bins=2048,
                                  exclude_zeros=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("cfg", [
    dict(GN, ACTIVATION="elu"), dict(BN, ACTIVATION="elu"),
    dict(GN, ACTIVATION="elu", HEADS=[["lm", 2, "sigmoid"],
                                      ["seg", 3, "softmax"]]),
], ids=["gn", "bn", "heads"])
def test_cached_train_step_3d_matches_cmrtpu(cfg):
    """cmrtpu's fused step with an identity optimizer (its update is the
    gradient), as tests/test_torch_train.py runs it: each gradient within
    1e-3 x its max |value| (the f32 gradients of a U-Net at a random init
    differ by that much between frameworks, PERF.md), the running averages
    within 1e-5."""
    cached_step_both(cfg)


def cached_step_both(cfg, supervision=False):
    """One cached train step of ``get_model(cfg, supervision)`` in both
    packages from cmrtpu's weights, held as
    ``test_cached_train_step_3d_matches_cmrtpu`` says."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(4, *cfg["DIM"])).astype(np.float32)
    ys = _cine_labels(rng, 4, *cfg["DIM"]) if len(cfg["DIM"]) == 3 \
        else _cine_labels(rng, 4, 1, *cfg["DIM"])[:, 0]
    metrics = jax_default_metrics(2)
    if "HEADS" in cfg:  # a label map per head, [4, 2, T, H, W]
        seg = rng.integers(0, 3, ys.shape).astype(np.float32)
        ys = np.stack([ys, seg], axis=1)
        concat = jax_concat_heads(cfg["HEADS"])  # as cmrtpu's Trainer does
        metrics = {name: (lambda yt, yp, f=fn: f(yt, concat(yp)))
                   for name, fn in metrics.items()}
    model = jax_get_model(cfg, supervision=supervision)
    variables = init_variables(model, cfg,
                               jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables))
    mesh = create_mesh(devices=jax.devices()[:1])
    identity = optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params=None: (grads, state))
    step = make_cached_train_step(model, identity, jax_get_loss(cfg),
                                  metrics, cfg, mesh, augment=False)
    state = S.create_train_state(model, variables, identity)
    dx, dy = upload_cache(xs, ys, mesh)
    new_state, ref_logs = step(state, dx, dy, jnp.arange(4, dtype=jnp.int32),
                               jax.random.key(0))

    port = get_model(cfg, supervision=supervision)
    port.load_state_dict(flax_to_state_dict(init["params"],
                                            init.get("batch_stats")))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    logs = DeviceCachedLoop(trainer, gen).train_step(torch.arange(4))

    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
    grads = flax_to_state_dict(jax.tree_util.tree_map(
        lambda new, old: np.array(new) - old, dict(new_state.params),
        init["params"]))
    for name, p in port.named_parameters():
        scale = np.abs(grads[name].numpy()).max()
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=0, atol=1e-3 * scale, err_msg=name)
    _, stats = state_dict_to_flax(port.state_dict())
    got, want = _flat(stats), _flat(new_state.batch_stats)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def _write_cine(root, n=8, t=T_FRAMES, hw=32, spacing=1.4):
    """tests/test_cine.py's cine files: [t, hw, hw] stacks with a bright
    and a dark 3x3 landmark (labels 1 and 2) per frame."""
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for i in range(n):
        ay, ax = 8 + rng.integers(-2, 3), 20 + rng.integers(-2, 3)
        iy, ix = 20 + rng.integers(-2, 3), 8 + rng.integers(-2, 3)
        img = rng.normal(0, 0.2, size=(t, hw, hw)).astype(np.float32)
        msk = np.zeros((t, hw, hw), np.uint8)
        img[:, ay - 1:ay + 2, ax - 1:ax + 2] += 2.0
        img[:, iy - 1:iy + 2, ix - 1:ix + 2] -= 2.0
        msk[:, ay - 1:ay + 2, ax - 1:ax + 2] = 1
        msk[:, iy - 1:iy + 2, ix - 1:ix + 2] = 2
        for kind, arr, paths in (("img", img, xs), ("msk", msk, ys)):
            path = os.path.join(root, f"patient{i:03d}__cine_{kind}.nrrd")
            write_image(MedicalImage(array=arr,
                                     spacing=(spacing, spacing, 1.0)), path)
            paths.append(path)
    return xs, ys


FIT = {"DIM": [T_FRAMES, 32, 32], "F_SIZE": [3, 3, 3], "M_POOL": [1, 2, 2],
       "BATCHSIZE": 4, "MASK_VALUES": [1, 2], "MASK_CLASSES": 2,
       "DEPTH": 2, "FILTERS": 4, "SEED": 0, "LEARNING_RATE": 1e-3,
       "MIXED_PRECISION": False, "RESAMPLE": False, "AUGMENT": True,
       "AUGMENT_PROB": 1.0, "SHIFTSCALEROTATE": True,
       "GRIDDISTORTION": False, "RANDOMROTATE": True}


def test_fit_cached_on_cine_files_loss_decreases(tmp_path):
    xs, ys = _write_cine(str(tmp_path))
    gen = DataGenerator(xs, ys, config=FIT)
    assert gen._cache_x.shape == gen._cache_y.shape == (8, T_FRAMES, 32, 32)
    trainer = Trainer(FIT, device="cpu")
    hist = trainer.fit_cached(gen, DataGenerator(xs[:2], ys[:2], config=FIT),
                              epochs=12)
    assert np.isfinite(hist[-1]["loss"]) and "val_loss" in hist[-1]
    assert hist[-1]["loss"] < hist[0]["loss"]
    out = trainer.predict(np.zeros((2, T_FRAMES, 32, 32, 1), np.float32))
    assert out.shape == (2, T_FRAMES, 32, 32, 2) and np.isfinite(out).all()


def test_generator_resamples_volumes_as_cmrtpu(tmp_path, monkeypatch):
    """RESAMPLE on a cine volume resamples each frame in plane with
    cmrtpu's arithmetic. cmrtpu's own call gives the resampled volume a
    2-axis spacing, which its image then rejects; its resample_image is
    wrapped here to keep the t axis's spacing."""
    import cmrtpu.ops.resample as jr

    def in_plane(img, size, spacing, interpolate=jr.NEAREST):
        out = jr.resample_nd(img.array, img.spacing, size, spacing,
                             interpolate)
        return img.with_array(out) if out.shape == img.array.shape else \
            type(img)(array=out, spacing=(*spacing,
                                          *img.spacing[len(spacing):]),
                      origin=img.origin, direction=img.direction)

    monkeypatch.setattr(jr, "resample_image", in_plane)
    xs, ys = _write_cine(str(tmp_path), n=2, hw=30, spacing=1.4)
    cfg = dict(FIT, RESAMPLE=True, SPACING=[1.2, 1.2], AUGMENT=False)
    got, want = DataGenerator(xs, ys, config=cfg), \
        JaxDataGenerator(xs, ys, config=cfg)
    assert got._cache_x.shape == (2, T_FRAMES, 32, 32)
    np.testing.assert_array_equal(got._cache_x, want._cache_x)
    np.testing.assert_array_equal(got._cache_y, want._cache_y)


@pytest.mark.parametrize("cfg", [BN, dict(GN, HEADS=[["lm", 2, "sigmoid"],
                                                     ["seg", 3, "softmax"]])],
                         ids=["bn", "heads"])
def test_trainer_and_predictor_predict_as_apply(cfg, tmp_path):
    variables = perturbed_variables(cfg, 8)
    x = np.random.default_rng(8).standard_normal(
        (2, *cfg["DIM"], 1)).astype(np.float32)
    want = jax_build_model(cfg).apply(variables, x, train=False)
    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(variables["params"],
                                            variables.get("batch_stats")))
    trainer = Trainer(cfg, model=port, device="cpu")
    jax_ckpt.save_weights(str(tmp_path), variables["params"],
                          variables.get("batch_stats"))
    served = Predictor(cfg, str(tmp_path), device="cpu").predict(x)
    for got in (trainer.predict(x), served):
        if "HEADS" in cfg:
            assert set(got) == {"lm", "seg"}
            for name in got:
                np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                           atol=PROB_ATOL, rtol=0)
        else:
            np.testing.assert_allclose(got, np.asarray(want),
                                       atol=PROB_ATOL, rtol=0)


def test_monitor_localisation_raises_for_volumes():
    with pytest.raises(ValueError, match="2D landmark"):
        Trainer(dict(GN, MONITOR_LOCALISATION=True), device="cpu")


def test_cine_demo_cohort_and_run(tmp_path):
    """The ported demo writes cmrtpu's demo cohort (same draws, same
    arrays) and runs end to end on the CPU at a toy size, with the plain
    U-Net and with the (2+1)D one."""
    import importlib.util

    from cmrtpu_torch.io import read_image
    from cmrtpu_torch.tools.cine_quality_demo import (generate_cine_cohort,
                                                      main)

    spec = importlib.util.spec_from_file_location(
        "jax_cine_demo", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "cine_quality_demo.py"))
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    xs, ys, gts = generate_cine_cohort(str(tmp_path / "port"), 3, 4, 24)
    rxs, rys, rgts = jax_demo.generate_cine_cohort(str(tmp_path / "ref"), 3,
                                                   4, 24)
    for a, b in zip(xs + ys, rxs + rys):
        ia, ib = read_image(a), read_image(b)
        np.testing.assert_array_equal(ia.array, ib.array)
        assert ia.spacing == ib.spacing
    for pid in gts:
        np.testing.assert_array_equal(gts[pid], rgts[pid])

    summary = main(["--root", str(tmp_path / "run"), "--patients", "4",
                    "--epochs", "1", "--dim", "16", "--t-frames", "4",
                    "--depth", "2", "--filters", "4", "--device", "cpu"])
    assert summary["epochs"] == 1 and summary["landmarks"] == 16
    assert os.path.exists(tmp_path / "run" / "summary.json")
    summary = main(["--root", str(tmp_path / "run_2p1d"), "--patients",
                    "4", "--epochs", "1", "--dim", "16", "--t-frames", "4",
                    "--depth", "2", "--filters", "4", "--variant",
                    "unet_2p1d", "--device", "cpu"])
    assert summary["variant"] == "unet_2p1d" and summary["epochs"] == 1
    assert np.isfinite(summary["loss_last"])
