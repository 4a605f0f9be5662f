"""cmrtpu_torch's plain Gaussian blur and heatmap targets against cmrtpu's.

The plain torch ``gaussian_blur_2d`` (what the CPU runs, and what K1 is held
against on the card) goes against ``cmrtpu.ops.gaussian.gaussian_blur_2d``
and against the Pallas kernel ``gaussian_blur_2d_pallas`` in interpret mode,
as tests/test_pallas.py runs it, at atol 1e-5: all three sum the same
float32 taps, in other orders. Also against scipy in float64 at the same
tolerance. A numpy model of the CUDA kernel's block decomposition
(csrc/gaussian_blur.cu: strips of rows, chunks of columns, folded rows and
column table, shared-memory strides) is held to scipy at the same tolerance,
with unloaded shared memory as NaN so that a read outside what the kernel
loads shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from cmrtpu.ops.gaussian import gaussian_blur_2d as jax_blur
from cmrtpu.ops.gaussian import gaussian_kernel1d as jax_kernel1d
from cmrtpu.ops.gaussian import smooth_heatmap_targets as jax_smooth
from cmrtpu.ops.pallas_kernels import gaussian_blur_2d_pallas
from cmrtpu_torch.ops import cuda_kernels
from cmrtpu_torch.ops.gaussian import (gaussian_blur_2d, gaussian_kernel1d,
                                       smooth_heatmap_targets,
                                       symmetric_index)

torch.set_num_threads(1)


@pytest.mark.parametrize("sigma,shape", [
    (1, (3, 24, 28)), (2, (2, 32, 32)), (4, (2, 40, 36)),
    (2, (3, 37, 53)),            # odd sides
    (4, (2, 12, 12)),            # radius 16 > side: reflects twice
    (2, (1, 5, 9)),
], ids=["s1", "s2", "s4", "odd", "r-ge-side", "tiny"])
def test_plain_blur_matches_cmrtpu_and_pallas(sigma, shape):
    x = np.random.default_rng(sigma).random(shape).astype(np.float32)
    got = gaussian_blur_2d(torch.from_numpy(x), sigma).numpy()
    ref = np.asarray(jax_blur(jnp.asarray(x), sigma))
    pallas = np.asarray(gaussian_blur_2d_pallas(jnp.asarray(x), sigma))
    scipy_ref = np.stack([scipy.ndimage.gaussian_filter(
        s.astype(np.float64), sigma, mode="reflect", truncate=4.0)
        for s in x])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, scipy_ref, atol=1e-5, rtol=0)


def test_kernel1d_and_impulse():
    for sigma in (0.5, 1, 2, 4):
        np.testing.assert_array_equal(gaussian_kernel1d(sigma),
                                      jax_kernel1d(sigma))
    x = np.zeros((1, 33, 33), np.float32)
    x[0, 16, 16] = 1.0
    out = gaussian_blur_2d(torch.from_numpy(x), 2).numpy()
    assert out.sum() == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("n,radius", [(1, 3), (5, 0), (5, 4), (3, 11)])
def test_symmetric_index_is_numpy_symmetric_pad(n, radius):
    np.testing.assert_array_equal(
        symmetric_index(n, radius).numpy(),
        np.pad(np.arange(n), radius, mode="symmetric"))


@pytest.mark.parametrize("sigma", [1, 2])
def test_smooth_heatmap_targets_per_example(sigma):
    rng = np.random.default_rng(7)
    masks = np.zeros((4, 32, 28, 2), np.float32)
    masks[0, 5:7, 8:10, 0] = 1
    masks[0, 20:22, 12:14, 1] = 1
    masks[1, 10:12, 3:5, 1] = 1              # one channel only
    masks[3] = rng.random((32, 28, 2)) > 0.97
    # masks[2] stays empty: no landmark, the targets stay all zeros
    got = smooth_heatmap_targets(torch.from_numpy(masks), sigma).numpy()
    ref = np.asarray(jax.vmap(lambda m: jax_smooth(m, sigma))(
        jnp.asarray(masks)))
    assert got.shape == masks.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert not got[2].any()
    for b in (0, 1, 3):  # joint min-max over H, W and C of each example
        assert got[b].max() == pytest.approx(1.0, abs=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.gaussian_blur_2d_cuda(torch.zeros(1, 8, 8), 2)
    # the radius limit: the smallest block (4 rows by 32 columns) with its
    # halo rows, scratch and column table in 227 KB
    assert cuda_kernels.blur_smem_bytes(cuda_kernels.BLUR_MAX_RADIUS) \
        <= cuda_kernels.SMEM_LIMIT
    assert cuda_kernels.blur_smem_bytes(cuda_kernels.BLUR_MAX_RADIUS + 1) \
        > cuda_kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match="radius"):
        cuda_kernels.blur_geometry(224, 224, cuda_kernels.BLUR_MAX_RADIUS + 1)


@pytest.mark.parametrize("h,w,radius,want", [
    (224, 224, 8, (28, 224)),      # the training path: full-width strips
    (224, 224, 16, (28, 224)),
    (37, 53, 8, (28, 56)),
    (5, 9, 4, (8, 12)),
    (2048, 2048, 8, None),         # too wide for one block: chunks
    (512, 4096, 64, None),
    (64, 64, 108, None),           # the largest radius
])
def test_blur_geometry_fits_shared_memory(h, w, radius, want):
    strip, chunk = cuda_kernels.blur_geometry(h, w, radius)
    if want is not None:
        assert (strip, chunk) == want
    assert strip % 4 == 0 and chunk % 4 == 0
    assert cuda_kernels.BLUR_MIN_STRIP <= strip <= \
        cuda_kernels.BLUR_STRIP_ROWS
    assert cuda_kernels.blur_smem_bytes(radius, strip, chunk) \
        <= cuda_kernels.SMEM_LIMIT


def _round4(v):
    return (v + 3) & ~3


def _fold(i, n):
    """The kernel's fold: np.pad 'symmetric' source index, period 2n."""
    while i < 0 or i >= n:
        i = -i - 1 if i < 0 else 2 * n - 1 - i
    return i


def k1_model(x, taps, strip, chunk):
    """csrc/gaussian_blur.cu in numpy: per (slice, strip, chunk) block the
    shared-memory input rows and column table the kernel builds, then its
    two passes. Shared memory starts as NaN."""
    n, h, w = x.shape
    r = (taps.size - 1) // 2
    ins, tms = _round4(chunk + 2 * r) + 8, _round4(chunk + 2 * r + 4)
    w_vecs = (2 * r + 7) >> 2
    vec = w % 4 == 0
    out = np.full(x.shape, np.nan, np.float32)
    for b in range(n):
        for y0 in range(0, h, strip):
            for x0 in range(0, w, chunk):
                rows, cols = min(strip, h - y0), min(chunk, w - x0)
                cx0, cx1 = max(0, x0 - r) & ~3, min(w, x0 + cols + r)
                span = _round4(cx1 - cx0) if vec else cx1 - cx0
                load_rows = _round4(rows) + 2 * r
                assert cx0 + span <= w and span <= ins
                assert load_rows <= strip + 2 * r
                s_in = np.full((strip + 2 * r, ins), np.nan, np.float32)
                for k in range(load_rows):
                    s_in[k, :span] = x[b, _fold(y0 - r + k, h),
                                       cx0:cx0 + span]
                col = np.array([_fold(x0 - r + c, w) - cx0
                                for c in range(cols + 2 * r)])
                assert col.min() >= 0 and col.max() < cx1 - cx0
                tmp = np.full((strip, tms), np.nan, np.float32)
                for i in range(_round4(rows)):  # 4 rows a thread
                    acc = np.zeros(col.size, np.float32)
                    for t, tap in enumerate(taps):
                        acc += tap * s_in[i + t, col]
                    tmp[i, :col.size] = acc
                for i in range(rows):
                    assert _round4(cols) - 4 + 4 * w_vecs <= tms
                    acc = np.zeros(cols, np.float32)
                    for t, tap in enumerate(taps):
                        acc += tap * tmp[i, t:t + cols]
                    out[b, y0 + i, x0:x0 + cols] = acc
    return out


@pytest.mark.parametrize("sigma,shape,geometry", [
    (2, (2, 40, 32), None),
    (2, (3, 37, 53), None),          # odd sides: the scalar load path
    (4, (2, 12, 12), None),          # radius 16 > side: folds twice
    (1.5, (2, 30, 44), (8, 12)),     # chunks whose windows start unaligned
    (2, (1, 21, 70), (4, 32)),       # the smallest block, ragged edges
    (3, (2, 9, 7), (4, 32)),         # radius 12 > both sides
], ids=["full-width", "odd", "r-ge-side", "chunks", "smallest", "r-ge-both"])
def test_kernel_block_model_matches_scipy(sigma, shape, geometry):
    x = np.random.default_rng(11).random(shape).astype(np.float32)
    taps = gaussian_kernel1d(sigma)
    radius = (taps.size - 1) // 2
    strip, chunk = geometry or cuda_kernels.blur_geometry(
        shape[1], shape[2], radius)
    got = k1_model(x, taps, strip, chunk)
    want = np.stack([scipy.ndimage.gaussian_filter(
        s.astype(np.float64), sigma, mode="reflect", truncate=4.0)
        for s in x])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,radius", [(1, 3), (5, 2), (5, 7), (3, 11)])
def test_kernel_fold_is_numpy_symmetric_pad(n, radius):
    np.testing.assert_array_equal(
        [_fold(i, n) for i in range(-radius, n + radius)],
        np.pad(np.arange(n), radius, mode="symmetric"))
