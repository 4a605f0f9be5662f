"""REMAT in cmrtpu_torch against cmrtpu's ``nn.remat`` on the CPU.

REMAT 0, 1 and True build one parameter tree and compute one function;
only the memory a train step holds changes. Dropout is on: the port's
masks are injected in the order its blocks draw them, the masks that
cmrtpu's train forward drew from its dropout key (read off its Dropout
modules' outputs), so both packages run the same function.

* loss within rel 1e-5 and every gradient within 1e-5 of the largest of
  cmrtpu's REMAT run (f32; the convolutions sum in another order, and
  cmrtpu's own REMAT gradients lie ~1e-5 from its REMAT 0 ones);
* the running averages after one BatchNorm step within 1e-6 of cmrtpu's;
* in the port, REMAT 1 and True give REMAT 0's loss and running averages
  exactly and its gradients within 1e-6 of the largest, with a real
  ``torch.Generator`` drawing the masks;
* controls: a wrap that does not replay the generator in the recompute
  (``checkpoint`` saves only torch's global generators) differs from
  REMAT 0's gradients by far more than that bound, and a wrap that lets
  the recompute move the running averages breaks their equality.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu_torch.models import unet as U
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.train.checkpoint import flax_to_state_dict, state_dict_to_flax
from test_torch_unet import perturbed_variables

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 3, "FILTERS": 4, "MASK_CLASSES": 2,
       "MIXED_PRECISION": False, "BATCH_NORMALISATION": True,
       "DROPOUT_MIN": 0.3, "DROPOUT_MAX": 0.5}
REMATS = [0, 1, True]
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5  # times the largest |g| of cmrtpu's run
STATS_ATOL = 1e-6
SELF_GRAD_ATOL = 1e-6  # port REMAT against port REMAT 0, times max |g|


def _inputs(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *CFG["DIM"], 1)).astype(np.float32)
    y = (rng.random((batch, *CFG["DIM"], 2)) > 0.9).astype(np.float32)
    return x, y


def _jax_step(cfg, variables, x, y, key):
    """cmrtpu's train forward under ``key``: loss, gradients by flax path
    and the moved running averages."""
    model = jax_build_model(cfg)

    def f(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True, rngs={"dropout": key},
                               mutable=["batch_stats"])
        return ((out - y) ** 2).mean(), mut

    (loss, mut), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    return float(loss), _flat(grads), _flat(mut["batch_stats"])


def _jax_masks(cfg, variables, x, key):
    """The keep masks cmrtpu's REMAT 0 train forward draws under ``key``,
    from its Dropout outputs and their inputs (an element dropped shows
    as 0 where its input is not 0), NCHW, in the order the port draws
    them."""
    _, state = jax_build_model(cfg).apply(
        variables, x, train=True, rngs={"dropout": key},
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    inter = state["intermediates"]

    def out(*path):
        node = inter
        for p in path:
            node = node[p]
        return np.asarray(node["__call__"][0])

    depth = cfg["DEPTH"]
    scopes = [(f"DownBlock_{i}",) for i in range(depth)] + [()] + \
        [(f"UpBlock_{i}",) for i in range(depth)]
    masks = []
    for scope in scopes:
        dropped, before = out(*scope, "Dropout_0"), out(*scope, "ConvBlock_0")
        keep = (dropped != 0) | (before == 0)
        masks.append(torch.from_numpy(np.moveaxis(keep, -1, 1).copy()))
    return masks


class MaskStream:
    """A stand-in for the dropout generator that hands out given masks in
    order; its state is the position, so the remat replay works on it."""

    def __init__(self, masks):
        self.masks, self.i = masks, 0

    def get_state(self):
        return self.i

    def set_state(self, i):
        self.i = i

    def next(self, shape):
        mask = self.masks[self.i]
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        self.i += 1
        return mask


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_step(cfg, variables, x, y, generator):
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    model.train()
    out = model(torch.from_numpy(x), generator=generator)
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    params, stats = state_dict_to_flax(
        {**{n: g for n, g in grads.items()},
         **{n: b for n, b in model.named_buffers()}})
    return float(loss.detach()), _flat(params), _flat(stats)


@pytest.fixture(scope="module")
def case():
    variables = perturbed_variables(CFG, 3)
    x, y = _inputs()
    key = jax.random.key(11, impl="threefry2x32")
    return variables, x, y, key, _jax_masks(CFG, variables, x, key)


@pytest.mark.parametrize("remat", REMATS, ids=["remat0", "remat1",
                                               "remat_true"])
def test_remat_matches_cmrtpu_with_dropout_on(case, remat, monkeypatch):
    variables, x, y, key, masks = case
    cfg = dict(CFG, REMAT=remat)
    want_loss, want_g, want_s = _jax_step(cfg, variables, x, y, key)
    monkeypatch.setattr(U, "_keep_mask",
                        lambda shape, rate, gen, device: gen.next(shape))
    loss, grads, stats = _port_step(cfg, variables, x, y, MaskStream(masks))
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert grads.keys() == want_g.keys()
    scale = max(np.abs(g).max() for g in want_g.values())
    for name, g in want_g.items():
        np.testing.assert_allclose(grads[name], g, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=name)
    assert stats.keys() == want_s.keys()
    for name, s in want_s.items():
        np.testing.assert_allclose(stats[name], s, rtol=0, atol=STATS_ATOL,
                                   err_msg=name)


def _generator_step(remat, x, y, variables):
    return _port_step(dict(CFG, REMAT=remat), variables, x, y,
                      torch.Generator().manual_seed(5))


def _grad_gap(a, b):
    scale = max(np.abs(g).max() for g in a.values())
    return max(np.abs(a[k] - b[k]).max() for k in a) / scale


@pytest.mark.parametrize("remat", [1, True], ids=["remat1", "remat_true"])
def test_remat_equals_no_remat_with_a_generator(case, remat):
    variables, x, y, _, _ = case
    loss0, grads0, stats0 = _generator_step(0, x, y, variables)
    loss, grads, stats = _generator_step(remat, x, y, variables)
    assert loss == loss0
    assert _grad_gap(grads0, grads) <= SELF_GRAD_ATOL
    for name, s in stats0.items():
        np.testing.assert_array_equal(stats[name], s, err_msg=name)


def test_controls_break_the_checks(case, monkeypatch):
    """Without the generator replay the recompute draws other masks, and
    the gradients move far outside the bound; without the frozen
    statistics the running averages move twice."""
    variables, x, y, _, _ = case
    loss0, grads0, stats0 = _generator_step(0, x, y, variables)
    with monkeypatch.context() as m:
        m.setattr(U, "_replayed",
                  lambda gen, state: contextlib.nullcontext())
        loss, grads, stats = _generator_step(True, x, y, variables)
    assert loss == loss0  # the forward is the same; its gradient is not
    assert _grad_gap(grads0, grads) > 100 * SELF_GRAD_ATOL
    with monkeypatch.context() as m:
        m.setattr(U, "_frozen_stats", lambda block: contextlib.nullcontext())
        _, _, stats = _generator_step(True, x, y, variables)
    moved = [k for k in stats0 if not np.array_equal(stats[k], stats0[k])]
    assert moved and all(k.startswith(("DownBlock", "UpBlock"))
                         for k in moved)


def test_remat_keeps_the_state_dict_keys():
    keys = {r: set(build_model(dict(CFG, REMAT=r)).state_dict())
            for r in REMATS}
    assert keys[0] == keys[1] == keys[True]
    assert build_model(dict(CFG, REMAT=True)).n_remat == CFG["DEPTH"]
    assert build_model(dict(CFG, REMAT=2)).n_remat == 2
    assert build_model(CFG).n_remat == 0


def test_remat_reaches_the_hybrid_trunks():
    cfg = dict(CFG, DIM=[4, 32, 32], F_SIZE=[3, 3, 3], M_POOL=[1, 2, 2],
               REMAT=1, MODEL_VARIANT="avg")
    model = get_model(cfg)
    assert model.unet_2d.n_remat == 1 and model.unet_3d.n_remat == 1


def test_flax_remat_draws_the_masks_of_remat0(case):
    """The injected masks come from cmrtpu's REMAT 0 forward: its remat
    runs draw the same ones (their outputs agree to rounding)."""
    variables, x, _, key, _ = case
    outs = [np.asarray(jax_build_model(dict(CFG, REMAT=r)).apply(
        variables, x, train=True, rngs={"dropout": key},
        mutable=["batch_stats"])[0]) for r in REMATS]
    for out in outs[1:]:
        np.testing.assert_allclose(out, outs[0], rtol=0, atol=1e-4)
