"""Separable Gaussian heatmap synthesis — counterpart of
``cmrtpu/ops/gaussian.py``.

Binary landmark channels are blurred with a separable Gaussian (scipy
parity: truncate=4.0, 'reflect' border) and then min-max normalised jointly
over all channels of an example, like ``normalise_image(mask, 'minmax')`` in
the reference (ref: src/data/Generators.py:385-391). On a CUDA tensor the
blur is K1, the hand-written kernel ``gaussian_blur_2d_cuda``
(``csrc/gaussian_blur.cu``); on a CPU tensor it is the plain torch
``gaussian_blur_2d`` below, which is also what the kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from cmrtpu_torch.ops.cuda_kernels import gaussian_blur_2d_cuda

_EPS = float(np.finfo(np.float32).eps)


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage parity: radius = int(truncate*sigma + 0.5), normalised."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def symmetric_index(n: int, radius: int, device=None) -> torch.Tensor:
    """Source indices of ``np.pad(..., radius, mode='symmetric')`` along an
    axis of length n: i < 0 reads -i-1, i >= n reads 2n-1-i, folded with
    period 2n as often as a radius larger than the side needs.
    (``F.pad(mode='reflect')`` is scipy's 'mirror', not 'reflect'.)"""
    i = torch.remainder(torch.arange(-radius, n + radius, device=device),
                        2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _blur_axis(x: torch.Tensor, kernel: torch.Tensor, dim: int) -> torch.Tensor:
    """Blur along ``dim`` (-1 or -2) of [..., H, W]: symmetric pad by index
    gather, then one multiply-add per tap."""
    n = x.shape[dim]
    radius = (kernel.numel() - 1) // 2
    padded = x.index_select(dim, symmetric_index(n, radius, x.device))
    acc = torch.zeros_like(x)
    for t in range(kernel.numel()):
        acc = acc + kernel[t] * padded.narrow(dim, t, n)
    return acc


def gaussian_blur_2d(img: torch.Tensor, sigma: float,
                     truncate: float = 4.0) -> torch.Tensor:
    """Plain torch blur of the trailing two axes of [..., H, W] (float32),
    along W first and then H, as ``cmrtpu.ops.gaussian.gaussian_blur_2d``
    does."""
    kernel = torch.from_numpy(gaussian_kernel1d(sigma, truncate)).to(
        img.device)
    out = _blur_axis(img.float(), kernel, -1)
    return _blur_axis(out, kernel, -2)


def _blur_stack(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """[N, H, W] float32 blur: K1 for a CUDA tensor, the plain version for a
    CPU tensor, an error for anything else."""
    if x.device.type == "cuda":
        return gaussian_blur_2d_cuda(x.contiguous(), sigma)
    if x.device.type == "cpu":
        return gaussian_blur_2d(x, sigma)
    raise ValueError(f"no Gaussian blur on {x.device}")


def smooth_heatmap_targets(mask_channels: torch.Tensor,
                           sigma: float) -> torch.Tensor:
    """Binary channel masks [B, H, W, C] or [B, T, H, W, C] -> normalised
    Gaussian heatmaps, each [H, W] plane blurred on its own.

    Each example is min-max normalised jointly over all its axes (T, H, W
    and C), which is ``cmrtpu``'s ``smooth_heatmap_targets`` applied per
    example, as its ``finalize_batch`` does (ref: Generators.py:391
    normalises the stacked mask of one example globally). An example with
    no landmark stays all zeros. The layout at this boundary is JAX's,
    channels last; the blur runs on the [B*C*T, H, W] stack, one launch
    per call on the card."""
    b, h, w = mask_channels.shape[0], mask_channels.shape[-3], \
        mask_channels.shape[-2]
    moved = torch.movedim(mask_channels.float(), -1, 1)  # [B, C, ..., H, W]
    blurred = _blur_stack(moved.reshape(-1, h, w).contiguous(), sigma)
    flat = blurred.reshape(b, moved.shape[1:].numel())
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    out = (flat - lo) / (hi - lo + _EPS)
    return torch.movedim(out.reshape(moved.shape), 1, -1)
