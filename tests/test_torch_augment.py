"""cmrtpu_torch's batched augmentation against cmrtpu.pipeline.augment on
injected parameters.

torch cannot replay JAX's PRNG, so the parameters are drawn once (numpy, and
jax.random for the grid-distortion factors, which cmrtpu draws inside
``_axis_coords`` from ``fold_in(gd_key, axis)``) and handed to both sides:
to cmrtpu by replacing its ``_draw_params`` for each example, to the port's
``apply_params`` as one batched dict. Tolerances: images within 1e-5 (the
same float32 bilinear arithmetic; gathers and sums may round differently in
the last bit), masks exact (nearest gather of the same coordinates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmrtpu.pipeline.augment as jax_aug
from cmrtpu_torch.pipeline.augment import (DISTORT_LIMIT, GRID_STEPS,
                                           apply_params, draw_params)

torch.set_num_threads(1)

B = 6


def _batch(h, w, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, h, w)).astype(np.float32)
    msks = rng.integers(0, 3, (B, h, w)).astype(np.float32)
    return imgs, msks


def _params(seed, mode, square):
    """Per-example parameters with every transform on in some example."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), B)
    factors = np.stack([np.stack([
        1.0 + np.asarray(jax.random.uniform(
            jax.random.fold_in(k, axis), (GRID_STEPS,),
            minval=-DISTORT_LIMIT, maxval=DISTORT_LIMIT))
        for axis in (0, 1)]) for k in keys]).astype(np.float32)
    return {
        "rot_k": (np.arange(B) % 4 if square else np.zeros(B)).astype(np.int32),
        "ssr_on": np.array([1, 0, 1, 1, 0, 1], bool),
        "shift": rng.uniform(-0.025, 0.025, (B, 2)).astype(np.float32),
        "gd_on": np.array([1, 1, 0, 1, 0, 1], bool),
        "gd_key": keys,
        "gd_factors": factors,
        "down_on": np.array([0, 1, 1, 0, 0, 1], bool),
        "border_mode": mode,
        "border_value": 0.25 if mode == 0 else 0.0,
    }


def _jax_augment(params, imgs, msks, monkeypatch):
    outs_i, outs_m = [], []
    for i in range(B):
        one = {k: v if k in ("border_mode", "border_value")
               else (v[i] if k == "gd_key" else jnp.asarray(v[i]))
               for k, v in params.items() if k != "gd_factors"}
        monkeypatch.setattr(jax_aug, "_draw_params", lambda key, cfg: one)
        im, m = jax_aug.augment_example(None, jnp.asarray(imgs[i]),
                                        jnp.asarray(msks[i]), {})
        outs_i.append(np.asarray(im))
        outs_m.append(np.asarray(m))
    return np.stack(outs_i), np.stack(outs_m)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(32, 32), (24, 40)],
                         ids=["square", "oblong"])
def test_apply_params_matches_cmrtpu(mode, shape, monkeypatch):
    h, w = shape
    imgs, msks = _batch(h, w, seed=mode)
    params = _params(seed=10 + mode, mode=mode, square=h == w)
    ref_i, ref_m = _jax_augment(params, imgs, msks, monkeypatch)
    tp = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray)
          else v for k, v in params.items() if k != "gd_key"}
    tp["rot_k"] = tp["rot_k"].long()
    got_i, got_m = apply_params(tp, torch.from_numpy(imgs),
                                torch.from_numpy(msks))
    np.testing.assert_allclose(got_i.numpy(), ref_i, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_m.numpy(), ref_m)


def test_draw_params_gates_and_ranges():
    cfg = {"AUGMENT_PROB": 0.8, "RANDOMROTATE": True,
           "SHIFTSCALEROTATE": True, "GRIDDISTORTION": True,
           "DOWNSCALE": False, "BORDER_MODE": 4}
    p = draw_params(torch.Generator().manual_seed(0), cfg, 4000)
    assert not p["down_on"].any()                      # switched off
    # outer gate 0.8 times inner gate 0.8 (shift, grid) or 0.2 (rot90)
    assert p["ssr_on"].float().mean().item() == pytest.approx(0.64, abs=0.03)
    assert p["gd_on"].float().mean().item() == pytest.approx(0.64, abs=0.03)
    rot = (p["rot_k"] > 0).float().mean().item()
    assert rot == pytest.approx(0.8 * 0.2 * 0.75, abs=0.02)
    assert p["shift"].abs().max() <= 0.025
    assert p["gd_factors"].shape == (4000, 2, GRID_STEPS)
    assert ((p["gd_factors"] - 1).abs() <= DISTORT_LIMIT).all()
    same = draw_params(torch.Generator().manual_seed(0), cfg, 4000)
    assert all(torch.equal(torch.as_tensor(p[k]), torch.as_tensor(same[k]))
               for k in p)


def test_unaugmented_batch_passes_through():
    cfg = {"AUGMENT_PROB": 0.0, "RANDOMROTATE": True,
           "SHIFTSCALEROTATE": True, "GRIDDISTORTION": True,
           "DOWNSCALE": True}
    imgs, msks = _batch(32, 32, seed=3)
    p = draw_params(torch.Generator().manual_seed(1), cfg, B)
    got_i, got_m = apply_params(p, torch.from_numpy(imgs),
                                torch.from_numpy(msks))
    np.testing.assert_array_equal(got_i.numpy(), imgs)
    np.testing.assert_array_equal(got_m.numpy(), msks)
