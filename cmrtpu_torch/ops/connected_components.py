"""Largest-connected-component filtering on torch tensors — counterpart of
``cmrtpu/ops/connected_components.py``.

Two filters, as the CC_FILTER knob selects them: per slice with
4-connected components (``clean_prediction_2d_cc``), and per volume with
26-connected components (``clean_prediction_3d_cc``, CC_FILTER '3d'). A
component's id is its smallest linear index (in the slice, or in the
volume) and background is the sentinel 2**30. On a CUDA tensor the labels
come from the hand-written union-find kernels (``ops/cuda_kernels.py``); on
a CPU tensor from the plain torch versions below, iterative min-label
propagation (every foreground voxel seeded with its linear index takes the
min over its neighbourhood until a fixed point), which are also the
references the kernels are held against. Component sizes are counted with
one scatter-add and the biggest component is kept, as in the reference."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cmrtpu_torch.ops.cuda_kernels import (converge_labels_3d_cuda,
                                           converge_labels_cuda)

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


def _keep_largest(masks: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Keep, in each row of binary masks [N, ...], the component of min-index
    ``labels`` (the sentinel INF past every index) with the most voxels. On
    a tie the component with the smallest id wins; rows with no foreground
    pass through unchanged."""
    n = masks.shape[0]
    size = masks[0].numel() if n else 0
    flat_masks = masks.reshape(n, -1)
    flat = labels.reshape(n, -1)
    sizes = torch.zeros((n, size + 1), dtype=torch.int64, device=masks.device)
    sizes.scatter_add_(1, flat.clamp(0, size).long(), flat_masks.long())
    sizes[:, size] = 0  # sentinel bucket
    biggest = sizes.argmax(dim=1)  # first maximum = smallest component id
    keep = (flat == biggest[:, None]) & flat_masks
    has_fg = flat_masks.any(dim=1)
    return torch.where(has_fg[:, None], keep, flat_masks).reshape(masks.shape)


def largest_component_batch(masks: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 4-connected component per binary [N, H, W]
    slice. On a tie the component with the smallest id wins; slices with no
    foreground pass through unchanged."""
    masks = masks.bool()
    return _keep_largest(masks, _converge_batch(masks))


def largest_component_2d(mask: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 4-connected component of one binary [H, W]
    mask: ``largest_component_batch`` of a stack of one, so a CUDA tensor
    launches K2 once."""
    if mask.dim() != 2:
        raise ValueError(f"largest_component_2d takes one [H, W] mask, got "
                         f"{tuple(mask.shape)}")
    return largest_component_batch(mask[None])[0]


def _clean(pred_flat, label_values: Sequence[int], device,
           largest) -> torch.Tensor:
    """Per-label filter of a [..., Z, H, W] label volume (numpy or tensor)
    on ``device`` (default: the tensor's own, the CPU for numpy): the masks
    of all label values stacked [len(values), ..., Z, H, W] go through
    ``largest`` at once, one kernel launch on a CUDA device; a later label
    value overwrites an earlier one, as in the reference."""
    pred = torch.as_tensor(pred_flat, device=device)
    out = torch.zeros_like(pred)
    values = list(label_values)
    if not values:
        return out
    kept = largest(torch.stack([pred == val for val in values]))
    for val, keep in zip(values, kept):
        out = torch.where(keep, torch.as_tensor(val, dtype=pred.dtype,
                                                device=pred.device), out)
    return out


def clean_prediction_2d_cc(pred_flat, label_values: Sequence[int] = (1, 2),
                           device=None) -> torch.Tensor:
    """Per-slice, per-label biggest 4-connected component of a [Z, H, W]
    label volume (CC_FILTER true or '2d'), every slice of every label value
    in one [len(values) * Z, H, W] labelling. A [T, Z, H, W] cine is
    labelled the same way in one [len(values) * T * Z, H, W] launch: each
    slice is labelled on its own, so the result equals the volume-by-volume
    filter's."""
    return _clean(pred_flat, label_values, device,
                  lambda m: largest_component_batch(
                      m.flatten(0, -3)).reshape(m.shape))


def _axis_min(labels: torch.Tensor, dim: int) -> torch.Tensor:
    """Min of each voxel and its two neighbours along ``dim`` (INF past the
    edges)."""
    n = labels.shape[dim]
    inf = torch.full_like(labels.narrow(dim, 0, 1), INF)
    before = torch.cat([inf, labels.narrow(dim, 0, n - 1)], dim=dim)
    after = torch.cat([labels.narrow(dim, 1, n - 1), inf], dim=dim)
    return torch.minimum(torch.minimum(before, labels), after)


def _propagate_min_3d(labels: torch.Tensor) -> torch.Tensor:
    """One 26-neighbourhood min sweep over [N, Z, H, W]: the min over the
    3x3x3 cube is three separable axis mins, as the reference sweeps."""
    for dim in (1, 2, 3):
        labels = _axis_min(labels, dim)
    return labels


def label_components_3d(masks: torch.Tensor) -> torch.Tensor:
    """Plain torch 26-connected labels of binary volumes [N, Z, H, W] (or
    one [Z, H, W]), each volume with its own indices: out-of-place sweeps
    until no label changes, as ``cmrtpu``'s ``label_components_3d``.
    Returns int32 of the input's shape."""
    if masks.dim() == 3:
        return label_components_3d(masks[None])[0]
    masks = masks.bool()
    _, z, h, w = masks.shape
    idx = torch.arange(z * h * w, dtype=torch.int32,
                       device=masks.device).reshape(z, h, w)
    inf = torch.tensor(INF, dtype=torch.int32, device=masks.device)
    labels = torch.where(masks, idx, inf)
    while True:
        new = torch.where(masks, _propagate_min_3d(labels), inf)
        if torch.equal(new, labels):
            return labels
        labels = new


def _converge_volumes(masks: torch.Tensor) -> torch.Tensor:
    """Batched 26-connected labels [N, Z, H, W]: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor, an error for anything
    else."""
    if masks.device.type == "cuda":
        return converge_labels_3d_cuda(masks.contiguous())
    if masks.device.type == "cpu":
        return label_components_3d(masks)
    raise ValueError(f"no connected-component labelling on {masks.device}")


def largest_component_3d_batch(masks: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 26-connected component of each binary volume
    of [N, Z, H, W]. On a tie the component with the smallest id wins;
    volumes with no foreground pass through unchanged."""
    masks = masks.bool()
    return _keep_largest(masks, _converge_volumes(masks))


def clean_prediction_3d_cc(pred_flat, label_values: Sequence[int] = (1, 2),
                           device=None) -> torch.Tensor:
    """Per-label biggest 26-connected volume component of a [Z, H, W] label
    volume (CC_FILTER '3d', ``cmrtpu``'s ``clean_prediction_3d_cc``); a
    label with no voxel stays empty. Each [Z, H, W] volume of a [T, Z, H,
    W] cine is filtered on its own, all of them in one [len(values) * T, Z,
    H, W] launch."""
    return _clean(pred_flat, label_values, device,
                  lambda m: largest_component_3d_batch(
                      m.flatten(0, -4)).reshape(m.shape))


# -- host (numpy + scipy) filters: cmrtpu's cross-checks of the above --------

def _largest_host(mask: np.ndarray, structure=None) -> np.ndarray:
    """scipy's largest component of a binary mask (ties to the component
    met first in raster order, which has the smallest index)."""
    import scipy.ndimage

    labels, n = scipy.ndimage.label(mask, structure=structure)
    if n == 0:
        return np.zeros(mask.shape, bool)
    sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    return labels == 1 + int(np.argmax(sizes))


def clean_3d_prediction_2d_cc_host(pred) -> np.ndarray:
    """Per slice and nonzero label value of a [Z, H, W] label volume the
    largest 4-connected component, on the host with scipy (ref:
    clean_3d_prediction_2d_cc, Postprocess.py:108-120). 0 is the
    background: cmrtpu's host filter skips each slice's smallest value
    instead, so a slice with no background loses its only label there;
    here it keeps it, as the device filters do (ROADMAP Queue 3)."""
    pred = np.asarray(pred)
    cleaned = np.zeros_like(pred)
    for out, s in zip(cleaned, pred):
        for val in np.unique(s):
            if val != 0:
                out[_largest_host(s == val)] = val
    return cleaned


def clean_3d_prediction_3d_cc_host(pred) -> np.ndarray:
    """Per nonzero label value the largest 26-connected component of a [Z,
    H, W] label volume, on the host with scipy (ref:
    clean_3d_prediction_3d_cc, Postprocess.py:64-102). 0 is the
    background, as in ``clean_3d_prediction_2d_cc_host``; more than 9
    label values raise, as cmrtpu's assertion does."""
    pred = np.asarray(pred)
    values = np.unique(pred)
    if len(values) >= 10:
        raise ValueError(f"too many labels: {len(values)}")
    cleaned = np.zeros_like(pred)
    cube = np.ones((3, 3, 3), bool)
    for val in values:
        if val != 0:
            cleaned[_largest_host(pred == val, cube)] = val
    return cleaned
