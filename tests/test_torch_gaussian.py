"""cmrtpu_torch's plain Gaussian blur and heatmap targets against cmrtpu's.

The plain torch ``gaussian_blur_2d`` (what the CPU runs, and what K1 is held
against on the card) goes against ``cmrtpu.ops.gaussian.gaussian_blur_2d``
and against the Pallas kernel ``gaussian_blur_2d_pallas`` in interpret mode,
as tests/test_pallas.py runs it, at atol 1e-5: all three sum the same
float32 taps, in other orders. Also against scipy in float64 at the same
tolerance."""

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
    # the radius limit: a 32 x 32 tile plus its halo in 227 KB
    assert cuda_kernels.blur_smem_bytes(cuda_kernels.BLUR_MAX_RADIUS) \
        <= cuda_kernels.SMEM_LIMIT
    assert cuda_kernels.blur_smem_bytes(cuda_kernels.BLUR_MAX_RADIUS + 1) \
        > cuda_kernels.SMEM_LIMIT
