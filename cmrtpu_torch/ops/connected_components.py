"""Largest-connected-component filtering on torch tensors — counterpart of
``cmrtpu/ops/connected_components.py`` (2D part).

A component's id is its smallest linear index and background is the
sentinel 2**30. On a CUDA tensor the labels come from the hand-written
union-find kernel (``ops/cuda_kernels.py``); on a CPU tensor from the plain
torch version below, iterative min-label propagation (every foreground pixel
seeded with its linear index takes the min over its 4-neighbourhood until a
fixed point), which is also the reference the kernel is held against.
Component sizes are counted with one scatter-add and the biggest component
is kept, as in the reference."""

from __future__ import annotations

from typing import Sequence

import torch

from cmrtpu_torch.ops.cuda_kernels import converge_labels_cuda

INF = 2 ** 30


def _propagate_min(labels: torch.Tensor) -> torch.Tensor:
    """One 4-neighbourhood min sweep over [N, H, W] (edges padded with INF)."""
    inf_row = torch.full_like(labels[:, :1], INF)
    inf_col = torch.full_like(labels[:, :, :1], INF)
    up = torch.cat([labels[:, 1:], inf_row], dim=1)
    down = torch.cat([inf_row, labels[:, :-1]], dim=1)
    left = torch.cat([labels[:, :, 1:], inf_col], dim=2)
    right = torch.cat([inf_col, labels[:, :, :-1]], dim=2)
    return torch.minimum(labels, torch.minimum(torch.minimum(up, down),
                                               torch.minimum(left, right)))


def label_components_2d(masks: torch.Tensor) -> torch.Tensor:
    """Plain torch labels of a stack of binary masks [N, H, W]: out-of-place
    (Jacobi) sweeps until no label changes. Returns int32 [N, H, W]."""
    masks = masks.bool()
    _, h, w = masks.shape
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=masks.device).reshape(h, w)
    inf = torch.tensor(INF, dtype=torch.int32, device=masks.device)
    labels = torch.where(masks, idx, inf)
    while True:
        new = torch.where(masks, _propagate_min(labels), inf)
        if torch.equal(new, labels):
            return labels
        labels = new


def _converge_batch(masks: torch.Tensor) -> torch.Tensor:
    """Batched labels [N, H, W]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor, an error for anything else."""
    if masks.device.type == "cuda":
        return converge_labels_cuda(masks.contiguous())
    if masks.device.type == "cpu":
        return label_components_2d(masks)
    raise ValueError(f"no connected-component labelling on {masks.device}")


def largest_component_batch(masks: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 4-connected component per binary [N, H, W]
    slice. On a tie the component with the smallest id wins; slices with no
    foreground pass through unchanged."""
    masks = masks.bool()
    n, h, w = masks.shape
    labels = _converge_batch(masks)
    flat = labels.reshape(n, -1).clamp(0, h * w).long()
    sizes = torch.zeros((n, h * w + 1), dtype=torch.int64, device=masks.device)
    sizes.scatter_add_(1, flat, masks.reshape(n, -1).long())
    sizes[:, h * w] = 0  # sentinel bucket
    biggest = sizes.argmax(dim=1)  # first maximum = smallest component id
    keep = (labels == biggest[:, None, None]) & masks
    has_fg = masks.any(dim=2).any(dim=1)
    return torch.where(has_fg[:, None, None], keep, masks)


def clean_prediction_2d_cc(pred_flat, label_values: Sequence[int] = (1, 2),
                           device=None) -> torch.Tensor:
    """Per-slice, per-label biggest-component filter of a [Z, H, W] label
    volume (numpy or tensor), on ``device`` (default: the tensor's own, the
    CPU for numpy). The masks of all label values go through one
    [len(values) * Z, H, W] labelling, one kernel launch on a CUDA device;
    a later label value overwrites an earlier one, as in the reference."""
    pred = torch.as_tensor(pred_flat, device=device)
    out = torch.zeros_like(pred)
    values = list(label_values)
    if not values:
        return out
    kept = largest_component_batch(
        torch.cat([pred == val for val in values])).reshape(
            len(values), *pred.shape)
    for val, keep in zip(values, kept):
        out = torch.where(keep, torch.as_tensor(val, dtype=pred.dtype,
                                                device=pred.device), out)
    return out
