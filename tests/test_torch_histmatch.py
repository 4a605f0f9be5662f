"""cmrtpu_torch's histogram matching (Var.1) against cmrtpu's on the CPU.

* The binned matcher on batches of seeded slices with ties and zero
  borders, with and without ``exclude_zeros``: bin indices equal to the
  reference's arithmetic, matched values within 1e-6.
* The exact (sorted-quantile) matcher: within 1e-5.
* ``hist_quota`` equal on a grid of (prob, batch); ``gated_match`` equal to
  cmrtpu's ``_gated_match`` with the candidates, reference rows and gates
  that cmrtpu draws from its key handed to the port.
* One fused train step of the histmatch template's switches (HIST_MATCHING
  with AUGMENT at AUGMENT_PROB 0, so only the matcher changes the batch),
  with cmrtpu's draws injected: loss and metrics within rel 1e-5.
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
from cmrtpu.pipeline.histmatch import (match_histograms_binned_jax,
                                       match_histograms_jax)
from cmrtpu.train import device_cache as jax_dc
from cmrtpu.train import steps as S
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu.train.optimizers import get_optimizer as jax_get_optimizer
import cmrtpu_torch.train.device_cache as port_dc
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.pipeline.histmatch import (_binned_cdf, gated_match,
                                             hist_match_setup, hist_quota,
                                             match_histograms_binned,
                                             match_histograms_exact)
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG, _labels

torch.set_num_threads(1)


def _slices(seed, n=5, shape=(40, 36)):
    """MinMax-like slices with a zero border (the padded cache), a slice of
    few distinct values (ties), a constant slice and an all-zero one."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, *shape)).astype(np.float32) ** 1.5
    x[:, :3] = 0.0
    x[:, :, -2:] = 0.0
    x[1] = np.round(x[1] * 6) / 6
    x[2, 3:, :-2] = 0.4
    x[3] = 0.0
    return x


def _ref_bins(x, bins, exclude_zeros):
    """cmrtpu's bin indices: its binned_cdf's arithmetic on one slice."""
    x = jnp.asarray(x, jnp.float32).reshape(-1)
    if exclude_zeros:
        valid = x != 0.0
        lo = jnp.min(jnp.where(valid, x, jnp.inf))
        hi = jnp.max(jnp.where(valid, x, -jnp.inf))
    else:
        lo, hi = jnp.min(x), jnp.max(x)
    scale = jnp.maximum(hi - lo, jnp.float32(1e-12))
    return np.asarray(jnp.clip(((x - lo) / scale * bins).astype(jnp.int32),
                               0, bins - 1))


@pytest.mark.parametrize("bins", [2048, 64])
@pytest.mark.parametrize("exclude_zeros", [True, False],
                         ids=["exclude-zeros", "with-zeros"])
def test_binned_matches_cmrtpu(bins, exclude_zeros):
    src, ref = _slices(0), _slices(1)[::-1].copy()
    got = match_histograms_binned(torch.from_numpy(src),
                                  torch.from_numpy(ref), bins=bins,
                                  exclude_zeros=exclude_zeros).numpy()
    _, _, _, idx = _binned_cdf(torch.from_numpy(src).reshape(len(src), -1),
                               bins, exclude_zeros)
    for i, (s, r) in enumerate(zip(src, ref)):
        want = np.asarray(match_histograms_binned_jax(
            s, r, bins=bins, exclude_zeros=exclude_zeros))
        np.testing.assert_allclose(got[i], want, atol=1e-6, rtol=0,
                                   err_msg=f"slice {i}")
        valid = s.reshape(-1) != 0 if exclude_zeros else slice(None)
        np.testing.assert_array_equal(
            idx[i].numpy()[valid], _ref_bins(s, bins, exclude_zeros)[valid])
    if exclude_zeros:
        assert (got[src == 0] == 0).all()  # the border stays zero


def test_exact_matches_cmrtpu():
    src, ref = _slices(2), _slices(3)
    got = match_histograms_exact(torch.from_numpy(src),
                                 torch.from_numpy(ref)).numpy()
    for i, (s, r) in enumerate(zip(src, ref)):
        np.testing.assert_allclose(
            got[i], np.asarray(match_histograms_jax(s, r)), atol=1e-5,
            rtol=0, err_msg=f"slice {i}")


def test_hist_quota_matches_cmrtpu():
    for prob in (0.0, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0):
        for batch in (1, 2, 3, 7, 16, 32, 128):
            assert hist_quota(prob, batch) == jax_dc.hist_quota(prob, batch)


@pytest.mark.parametrize("bins", [2048, 0], ids=["binned", "exact"])
@pytest.mark.parametrize("prob", [0.1, 0.5], ids=["gated", "ungated"])
def test_gated_match_matches_cmrtpu(bins, prob):
    cfg = {"HIST_MATCHING": True, "HIST_MATCHING_BINS": bins,
           "HIST_MATCHING_PROB": prob}
    imgs, cache = _slices(4, n=8), _slices(5, n=6)
    quota, gate_p = hist_quota(prob, len(imgs))
    assert (gate_p < 1.0) == (prob == 0.1)
    key = jax.random.key(7)
    sel = np.array(jax.random.permutation(jax.random.key(8), 8)[:quota])
    jax_fn, _ = jax_dc._hist_match_setup(cfg, True)
    want = np.asarray(jax_dc._gated_match(
        jax_fn, jnp.asarray(imgs), jnp.asarray(cache), key, quota, gate_p,
        sel=jnp.asarray(sel)))
    # the reference rows and gates cmrtpu draws from its key
    k_ref, k_gate = jax.random.split(key)
    ref_idx = np.array(jax.random.randint(k_ref, (quota,), 0, len(cache)))
    gate = np.array(jax.random.bernoulli(k_gate, gate_p, (quota,))) \
        if gate_p < 1.0 else None
    port_fn, _ = hist_match_setup(cfg, True)
    got = gated_match(port_fn, torch.from_numpy(imgs),
                      torch.from_numpy(cache), torch.from_numpy(sel),
                      torch.from_numpy(ref_idx),
                      None if gate is None else torch.from_numpy(gate))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 if bins == 0
                               else 1e-6, rtol=0)
    assert hist_match_setup(cfg, False)[0] is None  # AUGMENT off: no Var.1


def test_histmatch_train_step_matches_cmrtpu(monkeypatch):
    cfg = dict(CFG, BATCHSIZE=8, ACTIVATION="elu", HIST_MATCHING=True,
               HIST_MATCHING_PROB=0.3, AUGMENT=True, AUGMENT_PROB=0.0,
               MONITOR_LOCALISATION=False)
    rng = np.random.default_rng(2)
    xs = np.concatenate([rng.random((8, 32, 32)), _slices(6, n=4,
                                                          shape=(32, 32))]
                        ).astype(np.float32)
    ys = _labels(rng, 12, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg, jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables["params"]))
    mesh = create_mesh(devices=jax.devices()[:1])
    optimizer = jax_get_optimizer(cfg)
    step = jax_dc.make_cached_train_step(
        model, optimizer, jax_get_loss(cfg), jax_default_metrics(2), cfg,
        mesh, augment=True)
    state = S.create_train_state(model, variables, optimizer)
    dx, dy = jax_dc.upload_cache(xs, ys, mesh)
    idxs = np.array([9, 0, 4, 11, 2, 7, 5, 10], np.int32)
    rng_key = jax.random.key(0)
    _, ref_logs = step(state, dx, dy, jnp.asarray(idxs), rng_key)

    # cmrtpu's draws of step 0 (device_cache.make_cached_train_step)
    quota, gate_p = hist_quota(0.3, 8)
    hm_key = jax.random.fold_in(jax.random.fold_in(rng_key, 0x415), 0)
    k_sel, k_gm = jax.random.split(hm_key)
    sel = np.array(jax.random.permutation(k_sel, 8)[:quota])
    k_ref, k_gate = jax.random.split(k_gm)
    ref_idx = np.array(jax.random.randint(k_ref, (quota,), 0, len(xs)))
    gate = np.array(jax.random.bernoulli(k_gate, gate_p, (quota,)))
    assert gate.any()  # the step matches at least one example
    drawn = []

    def injected(generator, batch, n_cache, q, p):
        drawn.append((batch, n_cache, q, p))
        return (torch.from_numpy(sel), torch.from_numpy(ref_idx),
                torch.from_numpy(gate))

    monkeypatch.setattr(port_dc, "draw_match", injected)
    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    logs = DeviceCachedLoop(trainer, gen).train_step(
        torch.from_numpy(idxs).long())
    assert drawn == [(8, 12, quota, gate_p)]
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
