"""cmrtpu_torch's 3D connected components (CC_FILTER '3d') against cmrtpu
and scipy.

Labels are 26-connected, each component named by its least volume-linear
index, background 2**30. The plain torch version must equal cmrtpu's XLA
``label_components_3d`` and ``scipy.ndimage.label`` with a 3x3x3 structure
(relabelled to min-index ids) as int32 arrays; the kept volumes of
``clean_prediction_3d_cc`` must equal cmrtpu's. A numpy model of the CUDA
kernel's union-find (csrc/cc_labels_3d.cu: init, one union per foreground
voxel with each of its 13 backward neighbours, flatten), with its threads'
steps interleaved at random as concurrent atomics may run, is held to the
same labels. On a CPU tensor the plain version runs and the kernel's launch
counter stays at 0."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from cmrtpu.ops.connected_components import \
    clean_3d_prediction_3d_cc_host
from cmrtpu.ops.connected_components import \
    clean_prediction_3d_cc as jax_clean_3d
from cmrtpu.ops.connected_components import \
    label_components_3d as jax_labels_3d
from cmrtpu_torch.ops import connected_components as CC
from cmrtpu_torch.ops.cuda_kernels import (converge_labels_3d_cuda,
                                           converge_labels_cuda)
from test_torch_connected_components import _interleave, _root, _unite

torch.set_num_threads(1)

INF = 2 ** 30
CUBE = np.ones((3, 3, 3), bool)
# the 13 neighbours before a voxel in volume-linear order, as the kernel
# walks them: the 9 of the slice before, the 3 of the row above, the left
BACKWARD = [(-1, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)] \
    + [(0, -1, dx) for dx in (-1, 0, 1)] + [(0, 0, -1)]


def blobs(rng=None, z=5, h=20, w=18):
    """Landmark-like: small balls that span 2-3 slices, a few stray
    voxels."""
    rng = rng or np.random.default_rng(7)
    zz, yy, xx = np.mgrid[0:z, 0:h, 0:w]
    m = np.zeros((z, h, w), bool)
    for _ in range(4):
        c = rng.integers(0, (z, h, w))
        m |= (zz - c[0]) ** 2 + ((yy - c[1]) / 2.0) ** 2 \
            + ((xx - c[2]) / 2.0) ** 2 <= 1.5
    m |= rng.random(m.shape) < 0.01
    return m


def serpentine_3d(h=12, w=12, layers=3):
    """The longest geodesic: a boustrophedon corridor in every other slice,
    joined by one voxel in the slice between, at the end of one corridor
    and the start of the next (which runs the other way)."""
    serp = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        serp[r, :] = True
        if r + 1 < h:
            serp[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    ends = np.argwhere(serp)
    start, end = tuple(ends[0]), tuple(ends[-1])
    m = np.zeros((2 * layers - 1, h, w), bool)
    for j in range(layers):
        m[2 * j] = serp
        if j + 1 < layers:
            m[(2 * j + 1, *(end if j % 2 == 0 else start))] = True
    return m


def diagonal_singles():
    """Voxels that touch only across a corner of the cube, a chain along
    the volume's diagonal, and pairs that do not touch."""
    m = np.zeros((4, 9, 9), bool)
    for k in range(4):
        m[k, k, k] = True                       # one corner-linked chain
    m[0, 6, 6] = m[1, 7, 8] = True              # dx=2: two components
    m[2, 0, 8] = m[3, 1, 7] = True              # corner-touching pair
    return m


def empty_full():
    return np.stack([np.zeros((3, 6, 7), bool), np.ones((3, 6, 7), bool)])


def tie():
    """Two 8-voxel cubes; the one with the smaller least index is kept."""
    m = np.zeros((4, 10, 10), bool)
    m[2:4, 6:8, 1:3] = True
    m[0:2, 1:3, 6:8] = True
    return m


CASES = {
    "blobs": blobs,
    "random-0.3": lambda: np.random.default_rng(1).random((4, 12, 14)) < 0.3,
    "random-0.55": lambda: np.random.default_rng(2).random((4, 12, 12)) < 0.55,
    "serpentine": serpentine_3d,
    "diagonal-singles": diagonal_singles,
    "tie": tie,
}


def scipy_labels_3d(mask):
    """scipy 26-connected labels, each component renamed to its min
    volume-linear index."""
    lab, n = scipy.ndimage.label(mask, structure=CUBE)
    first = np.full(n + 1, INF, np.int64)
    np.minimum.at(first, lab.ravel(), np.arange(lab.size))
    return np.where(lab > 0, first[lab], INF).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_match_cmrtpu_and_scipy(case):
    mask = CASES[case]()
    got = CC.label_components_3d(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, scipy_labels_3d(mask))
    np.testing.assert_array_equal(
        got, np.asarray(jax_labels_3d(jnp.asarray(mask))))


def test_stacked_volumes_keep_their_own_indices():
    masks = np.stack([blobs(np.random.default_rng(s)) for s in range(3)])
    got = CC.label_components_3d(torch.from_numpy(masks)).numpy()
    for m, lab in zip(masks, got):
        np.testing.assert_array_equal(lab, scipy_labels_3d(m))
    got = CC.label_components_3d(torch.from_numpy(empty_full())).numpy()
    assert (got[0] == INF).all() and (got[1] == 0).all()


def _pred(seed):
    """A label volume of values {0, 1, 2}: blobs of each label plus noise,
    with background in every slice."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((5, 20, 18), np.float64)
    pred[blobs(rng)] = 1
    pred[blobs(rng)] = 2
    noise = rng.random(pred.shape) < 0.03
    pred[noise] = rng.choice([1.0, 2.0], int(noise.sum()))
    return pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_matches_cmrtpu(seed):
    pred = _pred(seed)
    out = CC.clean_prediction_3d_cc(pred, (1, 2)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_clean_3d(pred, (1, 2))))
    np.testing.assert_array_equal(
        out, clean_3d_prediction_3d_cc_host(pred.astype(np.uint8)))
    assert (out != pred).any()  # the filter removed something


def test_clean_empty_label_and_tie():
    pred = tie().astype(np.float64)            # label 1 only: 2 is empty
    out = CC.clean_prediction_3d_cc(pred, (1, 2)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_clean_3d(pred, (1, 2))))
    assert out[0, 1, 6] == 1 and out[2, 6, 1] == 0   # smaller id kept
    full = CC.clean_prediction_3d_cc(np.ones((2, 5, 5)), (1,)).numpy()
    assert (full == 1).all()
    assert not CC.clean_prediction_3d_cc(np.zeros((2, 5, 5)), ()).any()


def cc3d_model(mask, seed=0):
    """csrc/cc_labels_3d.cu in numpy: every foreground voxel its own parent,
    then per foreground voxel (a thread) its unions with its foreground
    backward neighbours in order, the threads' steps interleaved at random,
    then the flatten."""
    rng = random.Random(seed)
    z, h, w = mask.shape
    flat = mask.reshape(-1)
    parent = np.where(flat, np.arange(flat.size), INF).astype(np.int64)

    def thread(i):
        k, y, x = np.unravel_index(i, mask.shape)
        for dz, dy, dx in BACKWARD:
            kk, yy, xx = k + dz, y + dy, x + dx
            if kk >= 0 and 0 <= yy < h and 0 <= xx < w and mask[kk, yy, xx]:
                yield from _unite(parent, i, (kk * h + yy) * w + xx)

    _interleave([thread(i) for i in np.nonzero(flat)[0]], rng)
    for i in np.nonzero(flat)[0]:  # the flatten: roots no longer move
        parent[i] = _root(parent, i)
    return parent.reshape(mask.shape).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_union_find_model_matches_scipy(case):
    mask = CASES[case]()
    want = scipy_labels_3d(mask)
    for seed in range(2):  # two orders of the atomics, one answer
        np.testing.assert_array_equal(cc3d_model(mask, seed=seed), want)


def test_cpu_tensor_takes_plain_version_and_never_the_kernel():
    converge_labels_3d_cuda.launches = converge_labels_cuda.launches = 0
    pred = torch.from_numpy(_pred(3))
    CC.clean_prediction_3d_cc(pred, (1, 2))
    CC.largest_component_3d_batch(pred[None] > 0)
    assert converge_labels_3d_cuda.launches == 0
    assert converge_labels_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        converge_labels_3d_cuda(pred[None] > 0)
    assert converge_labels_3d_cuda.launches == 0
