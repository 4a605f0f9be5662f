"""cmrtpu_torch's 3D connected components (CC_FILTER '3d') against cmrtpu
and scipy.

Labels are 26-connected, each component named by its least volume-linear
index, background 2**30. The plain torch version must equal cmrtpu's XLA
``label_components_3d`` and ``scipy.ndimage.label`` with a 3x3x3 structure
(relabelled to min-index ids) as int32 arrays; the kept volumes of
``clean_prediction_3d_cc`` must equal cmrtpu's. A numpy model of the CUDA
kernel's tiled union-find (csrc/cc_labels_3d.cu: run-start parents and
``join_runs`` unions in each tile but for those two others imply, tile
roots as volume-linear indices, the unions across the tiles' faces, the
flatten), at several tile shapes and with its threads' steps interleaved
at random as concurrent atomics may run, is held to the same labels;
``join_runs`` itself is held to scipy on every pair of short windows, and
the kernel's bit masks to the model's rules. On a CPU tensor the plain
version runs and the kernel's launch counter stays at 0; the kernel's tile
geometry covers every voxel once within the card's limits."""

import functools
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
from cmrtpu_torch.ops.cuda_kernels import (CC3D_MAX_DEPTH, CC3D_ROWS,
                                           CC_TILE, STATIC_SMEM_LIMIT,
                                           cc3d_geometry, cc3d_smem_bytes,
                                           converge_labels_3d_cuda,
                                           converge_labels_cuda)
from test_torch_connected_components import _interleave, _root, _unite

torch.set_num_threads(1)

INF = 2 ** 30
CUBE = np.ones((3, 3, 3), bool)
# (columns, rows, slices) of the model's tiles: the kernel's are
# (CC_TILE, CC3D_ROWS, cc3d_geometry's depth)
TILES = [(4, 4, 2), (8, 4, 3)]


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


def corner_chains(step, shape=(7, 13, 17)):
    """Parallel chains along ``step`` whose voxels touch only across a
    cube's corner (a space diagonal) or edge (a plane's diagonal), three
    voxels apart from each other, so at the TILES' sizes they cross tiles
    through their corners, their edges and their front faces only: a chain
    holds the voxels whose two invariants along ``step`` are multiples of
    3."""
    zz, yy, xx = np.indices(shape)
    sz, sy, sx = step
    if sz:
        a, b = yy - sy * zz, xx - sx * zz
    else:
        a, b = zz, xx - sx * yy
    return (a % 3 == 0) & (b % 3 == 0)


def dilation_bridge():
    """A run over two runs one background voxel apart (one union per run of
    r & dilate(p) would join only one of them), in the slice before (dy -1,
    0, +1) and in the row above, inside one window of either model tile;
    and a single voxel that meets two runs across diagonals only, in the
    slice before and in the row above."""
    m = np.zeros((3, 12, 12), bool)
    for (z, y, x), (dz, dy) in [((1, 1, 0), (-1, 0)), ((1, 6, 0), (0, -1)),
                                ((2, 1, 8), (-1, 1)), ((1, 7, 8), (-1, -1))]:
        m[z, y, x:x + 4] = True
        m[z + dz, y + dy, [x, x + 1, x + 3]] = True
    m[1, 10, 1] = m[0, 10, 0] = m[0, 10, 2] = True
    m[2, 10, 9] = m[2, 9, 8] = m[2, 9, 10] = True
    return m


CASES = {
    "blobs": blobs,
    "random-0.3": lambda: np.random.default_rng(1).random((4, 12, 14)) < 0.3,
    "random-0.55": lambda: np.random.default_rng(2).random((4, 12, 12)) < 0.55,
    "serpentine": serpentine_3d,
    "diagonal-singles": diagonal_singles,
    "tie": tie,
    **{"corner-chains%+d%+d%+d" % step: functools.partial(corner_chains, step)
       for step in [(1, sy, sx) for sy in (1, -1) for sx in (1, -1)]
       + [(1, 0, 1), (1, 0, -1), (1, 1, 0), (1, -1, 0), (0, 1, 1),
          (0, 1, -1)]},
    "dilation-bridge": dilation_bridge,
    # Z, H and W no multiples of either model tile's sides
    "ragged-0.4": lambda: np.random.default_rng(3).random((5, 9, 13)) < 0.4,
    "ragged-0.7": lambda: np.random.default_rng(4).random((7, 11, 5)) < 0.7,
    "z1-0.5": lambda: np.random.default_rng(5).random((1, 12, 17)) < 0.5,
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


def _before(b):
    """Lane k holds lane k - 1 of b (nothing before the first)."""
    return np.concatenate([[False], b[:-1]])


def _after(b):
    """Lane k holds lane k + 1 of b (nothing after the last)."""
    return np.concatenate([b[1:], [False]])


def join_runs(r, p):
    """The kernel's join_runs on boolean windows r and p (lane k of p
    touches lanes k - 1, k and k + 1 of r): (lane of r, lane of p) of each
    union. One at the first lane of each run of r & p; where p is
    background at a lane of r, one with p's lane before (after) it when
    that one is foreground and r's is not."""
    pairs = [(k, k) for k in np.nonzero(
        r & p & ~(_before(r) & _before(p)))[0]]
    pairs += [(k, k - 1) for k in np.nonzero(
        r & ~p & _before(p) & ~_before(r))[0]]
    pairs += [(k, k + 1) for k in np.nonzero(
        r & ~p & _after(p) & ~_after(r))[0]]
    return pairs


def implied(r, lane, q):
    """The kernel's ``implied``: the lanes of a neighbour row whose union
    with lane ``lane``'s run of r two others imply, as they touch a voxel
    of rows q (boolean) that touches the run or a lane beside it."""
    run = np.zeros_like(r)
    lo = hi = lane
    while lo > 0 and r[lo - 1]:
        lo -= 1
    while hi + 1 < len(r) and r[hi + 1]:
        hi += 1
    run[lo:hi + 1] = True
    near = q & (run | _before(run) | _after(run))
    return near | _before(near) | _after(near)


def _local_pass(m, lab, index, origin, tile, rng):
    """The local kernel on one tile of the padded mask m: run-start parents
    in a tile-local array, join_runs with the row above and rows y-1, y,
    y+1 of the slice before but for the unions two others imply (with the
    row above: a voxel of rows y-1 and y of the slice before; with rows
    y-1 and y+1 of the slice before: a voxel of its row y), each union
    from run start to run start (the unions interleaved, as the block's
    threads take them from its queue), each voxel's tile root written to
    lab as a volume-linear index."""
    (x0, y0, z0), (tx, ty, tz) = origin, tile
    box = m[z0:z0 + tz, y0:y0 + ty, x0:x0 + tx]
    loc = np.full(box.size, -1, np.int64)

    def at(lz, ly, lx):
        return (lz * ty + ly) * tx + lx

    for lz, ly in np.ndindex(tz, ty):
        start = 0
        for lx in range(tx):
            if not box[lz, ly, lx]:
                start = lx + 1
            else:
                loc[at(lz, ly, lx)] = at(lz, ly, start)
    steps = []
    for lz, ly in np.ndindex(tz, ty):
        r = box[lz, ly]
        rows = []  # (row, the rows whose voxels imply a union with it)
        if ly > 0:
            rows.append(((lz, ly - 1), box[lz - 1, ly - 1] | box[lz - 1, ly]
                         if lz > 0 else np.zeros_like(r)))
        if lz > 0:
            rows += [((lz - 1, ly + dy), box[lz - 1, ly] if dy
                      else np.zeros_like(r)) for dy in (-1, 0, 1)
                     if 0 <= ly + dy < ty]
        for (pz, py), q in rows:
            steps += [_unite(loc, loc[at(lz, ly, a)], loc[at(pz, py, b)])
                      for a, b in join_runs(r, box[pz, py])
                      if not implied(r, a, q)[b]]
    _interleave(steps, rng)
    for lz, ly, lx in zip(*np.nonzero(box)):
        rz, rest = divmod(_root(loc, at(lz, ly, lx)), ty * tx)
        ry, rx = divmod(rest, tx)
        lab[index(z0 + lz, y0 + ly, x0 + lx)] = index(z0 + rz, y0 + ry,
                                                     x0 + rx)


def _face_unions(m, lab, index, origin, tile, shape):
    """The face kernel's unions for one tile of the padded mask m (as
    generators): its front slice against rows y-1, y, y+1 of the slice
    before, its top rows against row y0 - 1 of the slices z-1, z, z+1
    inside the tile, each window's lanes 0 and tx - 1 also against the
    voxels at x0 - 1 and x0 + tx; its left columns against column x0 - 1 of
    the slices z-1, z, z+1 inside the tile."""
    (x0, y0, z0), (tx, ty, tz), (z, h, w) = origin, tile, shape
    slices = min(tz, z - z0)
    steps = []

    def rows(k, y, kp, yp):
        r, p = m[k, y, x0:x0 + tx], m[kp, yp, x0:x0 + tx]
        pairs = join_runs(r, p)
        if x0 > 0 and r[0] and m[kp, yp, x0 - 1]:
            pairs.append((0, -1))
        if x0 + tx < w and r[tx - 1] and m[kp, yp, x0 + tx]:
            pairs.append((tx - 1, tx))
        steps.extend(_unite(lab, index(k, y, x0 + a), index(kp, yp, x0 + b))
                     for a, b in pairs)

    if z0 > 0:
        for y in range(y0, min(y0 + ty, h)):
            for yp in range(max(y - 1, 0), min(y + 1, h - 1) + 1):
                rows(z0, y, z0 - 1, yp)
    for k in range(z0, z0 + slices):
        near = range(max(k - 1, z0), min(k + 1, z0 + slices - 1) + 1)
        for kp in near if y0 > 0 else ():
            rows(k, y0, kp, y0 - 1)
        for kp in near if x0 > 0 else ():
            r, p = m[k, y0:y0 + ty, x0], m[kp, y0:y0 + ty, x0 - 1]
            steps.extend(_unite(lab, index(k, y0 + a, x0),
                                index(kp, y0 + b, x0 - 1))
                         for a, b in join_runs(r, p))
    return steps


def cc3d_model(mask, tile=(4, 4, 2), seed=0):
    """csrc/cc_labels_3d.cu in numpy, at tiles of ``tile`` = (columns,
    rows, slices): the local pass on each tile (its unions interleaved at
    random, step by step, as the atomics of a block may run), then the face
    unions of every tile interleaved, then the flatten."""
    rng = random.Random(seed)
    tx, ty, tz = tile
    z, h, w = mask.shape
    m = np.zeros((-(-z // tz) * tz, -(-h // ty) * ty, -(-w // tx) * tx), bool)
    m[:z, :h, :w] = mask  # lanes and rows past the volume: background
    lab = np.full(z * h * w, INF, np.int64)

    def index(k, y, x):
        return (k * h + y) * w + x

    origins = [(x0, y0, z0) for z0 in range(0, z, tz)
               for y0 in range(0, h, ty) for x0 in range(0, w, tx)]
    for origin in origins:
        _local_pass(m, lab, index, origin, tile, rng)
    _interleave([step for origin in origins for step in _face_unions(
        m, lab, index, origin, tile, mask.shape)], rng)
    for i in np.nonzero(lab != INF)[0]:  # the flatten: roots no longer move
        lab[i] = _root(lab, i)
    return lab.reshape(mask.shape).astype(np.int32)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_model_matches_scipy(case, tile):
    mask = CASES[case]()
    want = scipy_labels_3d(mask)
    for seed in range(2):  # two orders of the atomics, one answer
        np.testing.assert_array_equal(cc3d_model(mask, tile, seed), want)


def test_tiled_model_at_the_kernels_tile():
    """The kernel's own tile (32 columns, 8 rows, the geometry's depth) on
    a volume of 2 x 3 x 2 tiles with a ragged edge each way."""
    mask = np.random.default_rng(6).random((19, 21, 70)) < 0.45
    depth, _ = cc3d_geometry(*mask.shape)
    np.testing.assert_array_equal(
        cc3d_model(mask, (CC_TILE, CC3D_ROWS, depth)), scipy_labels_3d(mask))


@pytest.mark.parametrize("width", [1, 2, 3, 6])
def test_join_runs_joins_exactly_what_touches(width):
    """Every pair of windows r, p of ``width`` lanes: the runs of each
    (trees already) and join_runs' unions give the 8-connected components
    of the two rows one above the other."""
    for a, b in np.ndindex(2 ** width, 2 ** width):
        r = np.array([a >> k & 1 for k in range(width)], bool)
        p = np.array([b >> k & 1 for k in range(width)], bool)
        parent = list(range(2 * width))  # p's lanes, then r's

        def find(i):
            while parent[i] != i:
                i = parent[i]
            return i

        def union(i, j):
            parent[max(find(i), find(j))] = min(find(i), find(j))

        for row, bits in ((0, p), (1, r)):
            for k in range(1, width):
                if bits[k] and bits[k - 1]:
                    union(row * width + k, row * width + k - 1)
        for k, kp in join_runs(r, p):
            assert r[k] and p[kp] and abs(k - kp) <= 1
            union(width + k, kp)
        img = np.stack([p, r])
        lab, _ = scipy.ndimage.label(img, structure=np.ones((3, 3), bool))
        flat = lab.ravel()
        for i in range(2 * width):
            for j in range(2 * width):
                if flat[i] and flat[j]:
                    assert (find(i) == find(j)) == (flat[i] == flat[j]), \
                        (r, p)


def join_runs_bits(r, p, lane, first, last):
    """csrc/cc_labels_3d.cu join_runs on 32-bit masks, line for line: bit
    dx + 1 of the result to unite with p's lane + dx; returned as those p
    lanes (0, 1 or 2 of them)."""
    bit, full = 1 << lane, 0xFFFFFFFF
    r_before, p_before = (r << 1) & ~first & full, (p << 1) & ~first & full
    r_after, p_after = (r >> 1) & ~last, (p >> 1) & ~last
    if p & bit:
        out = 0 if r_before & p_before & bit else 2
    else:
        out = (1 if p_before & ~r_before & bit else 0) \
            | (4 if p_after & ~r_after & bit else 0)
    return [lane + dx for dx in (-1, 0, 1) if out >> (dx + 1) & 1]


def implied_bits(r, q, lane):
    """csrc/cc_labels_3d.cu run_around and implied on 32-bit masks, line
    for line: the lanes lane + dx whose bit dx + 1 is set."""
    full = 0xFFFFFFFF
    bg_before = ~r & ((1 << lane) - 1) & full
    start = bg_before.bit_length() if bg_before else 0
    bg_after = ~r & ~((2 << lane) - 1) & full
    below_end = (bg_after & -bg_after) - 1 if bg_after else full
    run = below_end & ~((1 << start) - 1) & full
    around = (run | run << 1 | run >> 1) & full
    near = q & around
    reach = (near | near << 1 | near >> 1) & full
    bits = (reach >> (lane - 1) if lane else reach << 1) & 7
    return [lane + dx for dx in (-1, 0, 1) if bits >> (dx + 1) & 1]


def test_kernel_implied_masks_match_the_model():
    rng = np.random.default_rng(9)
    for density in (0.2, 0.5, 0.8):
        for _ in range(100):
            r_bits, q_bits = rng.random((2, 32)) < density
            r = sum(1 << int(k) for k in np.nonzero(r_bits)[0])
            q = sum(1 << int(k) for k in np.nonzero(q_bits)[0])
            for lane in np.nonzero(r_bits)[0]:
                want = [c for c in np.nonzero(implied(r_bits, lane, q_bits))[0]
                        if abs(c - lane) <= 1]
                assert implied_bits(r, q, int(lane)) == want


@pytest.mark.parametrize("group", [32, 8], ids=["row", "columns"])
def test_kernel_bit_masks_match_join_runs(group):
    """The kernel's masks (a row of 32 lanes; 4 columns of 8 lanes in the
    left face, kColFirst 0x01010101, kColLast 0x80808080) give join_runs
    of each window."""
    first = sum(1 << k for k in range(0, 32, group))
    last = sum(1 << (k + group - 1) for k in range(0, 32, group))
    rng = np.random.default_rng(8)
    for density in (0.2, 0.5, 0.8):
        for _ in range(200):
            r_bits, p_bits = rng.random((2, 32)) < density
            r = sum(1 << k for k in np.nonzero(r_bits)[0])
            p = sum(1 << k for k in np.nonzero(p_bits)[0])
            got = [(k, kp) for k in np.nonzero(r_bits)[0]
                   for kp in join_runs_bits(r, p, k, first, last)]
            want = [(w0 + k, w0 + kp) for w0 in range(0, 32, group)
                    for k, kp in join_runs(r_bits[w0:w0 + group],
                                           p_bits[w0:w0 + group])]
            assert sorted(got) == sorted(want)


@pytest.mark.parametrize("z, h, w", [(1, 224, 224), (10, 224, 224),
                                     (16, 8, 32), (17, 9, 33), (20, 200, 190),
                                     (19, 203, 190), (49, 7, 5),
                                     (4096, 16, 16), (1, 1, 2 ** 29)])
def test_geometry_covers_every_voxel_once(z, h, w):
    depth, (tiles_x, tiles_y, tiles_z) = cc3d_geometry(z, h, w)
    assert 1 <= depth <= CC3D_MAX_DEPTH
    assert tiles_z == -(-z // CC3D_MAX_DEPTH)          # the fewest tiles
    # the tiles' slices start at multiples of depth: each slice is in one
    # tile, no tile lies past the volume, fewer empty slots than tiles
    assert (tiles_z - 1) * depth < z <= tiles_z * depth
    assert tiles_z * depth - z < tiles_z
    assert (tiles_x - 1) * CC_TILE < w <= tiles_x * CC_TILE
    assert (tiles_y - 1) * CC3D_ROWS < h <= tiles_y * CC3D_ROWS
    # the grids' x: the tiles, and at most 7 face blocks a tile (the
    # volumes, the grids' y, go in chunks of MAX_GRID_YZ)
    assert tiles_x * tiles_y * tiles_z * 7 < 2 ** 31
    assert cc3d_smem_bytes() <= STATIC_SMEM_LIMIT


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
