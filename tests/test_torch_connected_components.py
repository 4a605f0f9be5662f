"""cmrtpu_torch's connected-component filter against cmrtpu and scipy.

Labels must be equal as int32 arrays to the Pallas kernel (interpret mode on
the CPU), to the XLA ``label_components_2d`` and to scipy's labels relabelled
to min-index ids; kept masks must equal the JAX filter and the host (scipy)
filter. On a CPU tensor the plain torch version runs and the CUDA kernel's
launch counter stays at 0. A numpy model of the CUDA kernel's union-find
(csrc/cc_labels.cu: tile-local unions, border merge, flatten) with its
unions interleaved at random, as concurrent atomics may run, is held to the
same labels."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from cmrtpu.ops.connected_components import (clean_3d_prediction_2d_cc_host,
                                             label_components_2d as xla_labels)
from cmrtpu.ops.connected_components import \
    clean_prediction_2d_cc as jax_clean
from cmrtpu.ops.connected_components import \
    largest_component_batch as jax_largest
from cmrtpu.ops.pallas_kernels import converge_labels_pallas
from cmrtpu_torch.ops import connected_components as CC
from cmrtpu_torch.ops.cuda_kernels import converge_labels_cuda

torch.set_num_threads(1)


def serpentine(h=24, w=24):
    m = np.zeros((h, w), np.uint8)
    for r in range(0, h, 2):  # boustrophedon corridor (tests/test_pallas.py)
        m[r, :] = 1
        if r + 1 < h:
            m[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    return m[None]


def tie():
    m = np.zeros((1, 16, 20), np.uint8)
    m[0, 9:12, 2:5] = 1     # 9 px, larger min index
    m[0, 1:4, 14:17] = 1    # 9 px, smaller min index -> kept
    m[0, 14, 18] = 1
    return m


def empty_full_single():
    m = np.zeros((3, 16, 16), np.uint8)
    m[1] = 1
    m[2, 7, 9] = 1
    return m


def discs(rng, z, h, w, values):
    """Landmark-like label volume [Z, H, W]: per slice and label value one
    disc of radius 3 and 0-4 discs of radius 1-2 at random centres (about
    0.1% foreground per label at 224^2); a later value overwrites an
    earlier one."""
    yy, xx = np.mgrid[0:h, 0:w]
    pred = np.zeros((z, h, w), np.uint8)
    for k in range(z):
        for val in values:
            n_small = rng.integers(0, 5)
            for radius in (3, *rng.integers(1, 3, n_small)):
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                pred[k][np.hypot(yy - cy, xx - cx) <= radius] = val
    return pred


def landmark_like():
    """The masks the serving path stacks for K2: label 1's and label 2's."""
    pred = discs(np.random.default_rng(6), 3, 48, 40, (1, 2))
    return np.concatenate([pred == 1, pred == 2])


CASES = {
    "landmark-like": landmark_like,
    "random-0.2": lambda: (np.random.default_rng(1).random((3, 32, 32)) < 0.2),
    "random-0.55": lambda: (np.random.default_rng(2).random((3, 32, 40)) < 0.55),
    "random-0.8": lambda: (np.random.default_rng(3).random((3, 32, 32)) < 0.8),
    "serpentine": serpentine,
    "empty-full-single": empty_full_single,
    "tie": tie,
}


def scipy_min_index_labels(masks):
    """scipy 4-connected labels, each component renamed to its min index."""
    out = np.full(masks.shape, 2 ** 30, np.int32)
    for i, m in enumerate(masks):
        lab, n = scipy.ndimage.label(m)
        first = np.full(n + 1, 2 ** 30, np.int64)
        np.minimum.at(first, lab.ravel(), np.arange(lab.size))
        out[i] = np.where(lab > 0, first[lab], 2 ** 30)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_match_reference(case):
    masks = np.asarray(CASES[case](), np.uint8)
    got = CC.label_components_2d(torch.from_numpy(masks)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(converge_labels_pallas(masks)))
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(xla_labels)(jnp.asarray(masks) > 0)))
    np.testing.assert_array_equal(got, scipy_min_index_labels(masks))


@pytest.mark.parametrize("case", sorted(CASES))
def test_largest_component_matches_reference(case):
    masks = np.asarray(CASES[case](), bool)
    kept = CC.largest_component_batch(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(kept, np.asarray(jax_largest(masks)))
    host = clean_3d_prediction_2d_cc_host(masks.astype(np.uint8)) > 0
    # the host filter takes np.unique(slice)[1:] as the labels, so it drops
    # a slice with no background; the device filters keep it whole
    partial = ~masks.all(axis=(1, 2))
    np.testing.assert_array_equal(kept[partial], host[partial])
    np.testing.assert_array_equal(kept[~partial], masks[~partial])


def test_tie_keeps_smallest_component_id():
    kept = CC.largest_component_batch(torch.from_numpy(tie().astype(bool)))
    assert kept[0, 2, 15] and not kept[0, 10, 3] and not kept[0, 14, 18]


def test_two_touching_labels():
    """Label 1 and label 2 regions interleave and touch; each keeps its own
    biggest component, and the flat result equals cmrtpu's and scipy's."""
    rng = np.random.default_rng(4)
    pred = rng.choice([0.0, 1.0, 2.0], size=(4, 24, 24), p=[0.4, 0.3, 0.3])
    pred[0, 2:8, 2:8] = 1
    pred[0, 5:12, 6:14] = 2    # overlaps the label-1 square's box
    pred[3] = 0                # empty slice passes through
    out = CC.clean_prediction_2d_cc(pred, (1, 2)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_clean(pred, (1, 2))))
    np.testing.assert_array_equal(
        out.astype(np.uint8), clean_3d_prediction_2d_cc_host(
            pred.astype(np.uint8)))
    assert (out != pred).any()  # the filter removed something


def test_cpu_tensor_takes_plain_version_and_never_the_kernel():
    converge_labels_cuda.launches = 0
    masks = torch.from_numpy(np.random.default_rng(5).random((2, 16, 16)) < 0.5)
    CC.clean_prediction_2d_cc(masks.double(), (1,))
    CC.largest_component_batch(masks)
    assert converge_labels_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        converge_labels_cuda(masks)
    assert converge_labels_cuda.launches == 0


@pytest.mark.parametrize("values", [(1, 2), (1, 2, 3)], ids=["1-2", "1-2-3"])
def test_stacked_labels_match_cmrtpu(values):
    """One stacked labelling for every label value gives cmrtpu's filter
    and the host (scipy) filter; every slice holds background."""
    rng = np.random.default_rng(len(values))
    pred = discs(rng, 4, 40, 36, values)
    noise = rng.random(pred.shape) < 0.04  # stray pixels the filter drops
    pred[noise] = rng.choice(values, int(noise.sum()))
    assert (pred == 0).any(axis=(1, 2)).all()
    out = CC.clean_prediction_2d_cc(pred, values).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_clean(pred, values)))
    np.testing.assert_array_equal(out, clean_3d_prediction_2d_cc_host(pred))
    assert (out != pred).any()


def _interleave(steps, rng):
    """Run generators one step at a time in a random order, as the
    kernel's threads may interleave."""
    live = list(steps)
    while live:
        i = rng.randrange(len(live))
        try:
            next(live[i])
        except StopIteration:
            live[i] = live[-1]
            live.pop()


def _find(parent, a):
    """The kernel's find_root with path splitting, one step per read or
    atomicMin of a parent."""
    p = parent[a]
    yield
    while p != a:
        gp = parent[p]
        yield
        if gp != p:
            parent[a] = min(parent[a], gp)  # atomicMin
            yield
        a, p = p, gp
    return a


def _unite(parent, a, b):
    """The kernel's unite: min-root linking by atomicMin, retried from the
    old parent when the root had moved."""
    while True:
        a = yield from _find(parent, a)
        b = yield from _find(parent, b)
        if a == b:
            return
        a, b = min(a, b), max(a, b)
        old = parent[b]
        parent[b] = min(old, a)  # atomicMin: read and write in one step
        yield
        if old == b:
            return
        b = old


def _first_of_runs(bits):
    """Lanes that start a run of set lanes: the kernel's
    ``both & ~(both << 1)``."""
    return bits & ~np.concatenate([[False], bits[:-1]])


def _root(parent, a):
    while parent[a] != a:
        a = parent[a]
    return a


def k2_model(masks, tile=8, seed=0):
    """csrc/cc_labels.cu in numpy, at a tile side of ``tile``. Per tile:
    each pixel's parent is the first pixel of its run in the row, then one
    union per overlap of a run with a run of the row above, then each
    pixel's tile root written as a slice-linear index. Then one union per
    run of foreground pairs across each tile's top row and left column.
    Then the flatten. The unions of a phase interleave at random, step by
    step, as concurrent atomics may."""
    rng = random.Random(seed)
    n, h, w = masks.shape
    out = np.full(masks.shape, 2 ** 30, np.int64)
    for z in range(n):
        m = np.zeros((-(-h // tile) * tile, -(-w // tile) * tile), bool)
        m[:h, :w] = masks[z].astype(bool)
        lab = out[z].reshape(-1)
        for y0 in range(0, h, tile):
            for x0 in range(0, w, tile):
                box = m[y0:y0 + tile, x0:x0 + tile]
                loc = np.full(tile * tile, -1, np.int64)
                for ly in range(tile):
                    start = 0
                    for lx in range(tile):
                        if not box[ly, lx]:
                            start = lx + 1
                        else:
                            loc[ly * tile + lx] = ly * tile + start
                steps = [_unite(loc, ly * tile + lx, (ly - 1) * tile + lx)
                         for ly in range(1, tile) for lx in np.nonzero(
                             _first_of_runs(box[ly] & box[ly - 1]))[0]]
                _interleave(steps, rng)
                for ly, lx in zip(*np.nonzero(box)):
                    root = _root(loc, ly * tile + lx)
                    lab[(y0 + ly) * w + x0 + lx] = \
                        (y0 + root // tile) * w + x0 + root % tile
        steps = []
        for y0 in range(0, h, tile):
            for x0 in range(0, w, tile):
                if y0 > 0:  # top row against the row above
                    for x in x0 + np.nonzero(_first_of_runs(
                            m[y0, x0:x0 + tile] & m[y0 - 1, x0:x0 + tile]))[0]:
                        steps.append(_unite(lab, y0 * w + x, (y0 - 1) * w + x))
                if x0 > 0:  # left column against the column to its left
                    for y in y0 + np.nonzero(_first_of_runs(
                            m[y0:y0 + tile, x0] & m[y0:y0 + tile, x0 - 1]))[0]:
                        steps.append(_unite(lab, y * w + x0, y * w + x0 - 1))
        _interleave(steps, rng)
        for i in range(h * w):  # the flatten: roots no longer move
            if lab[i] != 2 ** 30:
                lab[i] = _root(lab, i)
    return out.astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_union_find_model_matches_reference(case):
    masks = np.asarray(CASES[case](), np.uint8)
    want = scipy_min_index_labels(masks)
    np.testing.assert_array_equal(
        want, np.asarray(converge_labels_pallas(masks)))
    for seed in range(2):  # two orders of the atomics, one answer
        np.testing.assert_array_equal(k2_model(masks, seed=seed), want)
