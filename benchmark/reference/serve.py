"""The reference's serving of one study in plain NumPy and PyTorch: the
deterministic preprocessing (in-plane resample to SPACING, quantile clip,
MinMax, centre pad/crop to DIM, MinMax), the float32 forward, the 0.5
threshold into labels {1, 2}, the largest 4-connected component per label
and slice, and the inverse steps back into the study's geometry (centre
pad/crop to the resampled size, nearest resample to the original grid).

Frozen from the reference repository's ``src/data/Preprocess.py`` and
``src/data/Postprocess.py`` semantics (ITK's linear resampling with a
zero default outside [-0.5, size - 0.5), RoundHalfIntegerUp for nearest).
It imports nothing of the program.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.unet import Forward

EPS = sys.float_info.epsilon


def resampled_size(size, spacing, target) -> list:
    new = np.asarray(size, np.float64) * np.asarray(spacing, np.float64) \
        / np.asarray(target, np.float64)
    return [int(v) for v in np.around(new).astype(np.int64)]


def _gather(arr: np.ndarray, axis: int, coords: np.ndarray,
            nearest: bool, fill=0) -> np.ndarray:
    size = arr.shape[axis]
    inside = (coords >= -0.5) & (coords < size - 0.5)
    shape = [1] * arr.ndim
    shape[axis] = len(coords)
    if nearest:
        idx = np.clip(np.floor(coords + 0.5).astype(np.int64), 0, size - 1)
        out = np.take(arr, idx, axis=axis)
    else:
        c = np.clip(coords, 0.0, size - 1.0)
        lo = np.floor(c).astype(np.int64)
        hi = np.minimum(lo + 1, size - 1)
        w = (c - lo).reshape(shape)
        out = (np.take(arr, lo, axis=axis).astype(np.float64) * (1.0 - w)
               + np.take(arr, hi, axis=axis).astype(np.float64) * w)
    return np.where(inside.reshape(shape), out, fill)


def resample(arr: np.ndarray, spacing_xyz, size_xyz, out_spacing_xyz,
             nearest: bool, fill=0) -> np.ndarray:
    """Resample the trailing len(size_xyz) axes of arr ([.., y, x] order;
    sizes and spacings in x, y(, z) order)."""
    out = np.asarray(arr)
    for k in range(len(size_xyz)):
        axis = arr.ndim - 1 - k
        coords = np.arange(int(size_xyz[k]), dtype=np.float64) \
            * (float(out_spacing_xyz[k]) / float(spacing_xyz[k]))
        out = _gather(out, axis, coords, nearest, fill)
    if nearest and np.issubdtype(arr.dtype, np.integer):
        return out.astype(arr.dtype)
    return out.astype(np.float32)


def pad_crop(arr: np.ndarray, target: Sequence[int],
             fill=0) -> np.ndarray:
    """Centre pad/crop; an odd difference gives the first margin the extra
    voxel."""
    out = np.full(tuple(int(t) for t in target), fill, arr.dtype)
    src, dst = [], []
    for s, t in zip(arr.shape, target):
        d = int(s) - int(t)
        if d < 0:
            n = -d
            dst.append(slice(n - n // 2, int(t) - n // 2))
            src.append(slice(0, s))
        else:
            dst.append(slice(0, int(t)))
            src.append(slice(d - d // 2, s - d // 2))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def minmax(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return (a - a.min()) / (a.max() - a.min() + EPS)


def preprocess(vol: np.ndarray, spacing_xy, cfg: Dict) -> np.ndarray:
    """[z, y, x] raw slices -> [z, *DIM, 1] model input."""
    target = list(reversed(cfg["SPACING"]))
    dim = tuple(cfg["DIM"])
    out = []
    for sl in vol:
        size = (sl.shape[1], sl.shape[0])
        if cfg.get("RESAMPLE"):
            sl = resample(sl, spacing_xy, resampled_size(size, spacing_xy,
                                                         target),
                          target, nearest=False)
        q = np.quantile(sl.reshape(-1), 0.999)
        a = minmax(np.clip(sl, 0.0, q))
        out.append(minmax(pad_crop(a.astype(np.float32), dim)))
    return np.stack(out)[..., None]


def component_labels(masks: torch.Tensor) -> torch.Tensor:
    """4-connected component labels of each [H, W] plane of bool masks
    [N, H, W]: each foreground pixel gets the smallest raster index in its
    component (plain propagation), background H * W."""
    n, h, w = masks.shape
    big = h * w
    idx = torch.arange(big, device=masks.device).reshape(1, h, w).expand(
        n, h, w)
    lab = torch.where(masks, idx, big)
    while True:
        new = lab.clone()
        new[:, 1:] = torch.minimum(new[:, 1:], lab[:, :-1])
        new[:, :-1] = torch.minimum(new[:, :-1], lab[:, 1:])
        new[:, :, 1:] = torch.minimum(new[:, :, 1:], lab[:, :, :-1])
        new[:, :, :-1] = torch.minimum(new[:, :, :-1], lab[:, :, 1:])
        new = torch.where(masks, new, big)
        if torch.equal(new, lab):
            return lab
        lab = new


def largest_component(masks: torch.Tensor) -> torch.Tensor:
    """Keep the largest 4-connected component of each [H, W] plane of
    bool masks [N, H, W]; a tie goes to the component whose first pixel
    in raster order comes first; empty planes stay empty."""
    n, h, w = masks.shape
    big = h * w
    flat = component_labels(masks).reshape(n, -1)
    sizes = torch.zeros((n, big + 1), dtype=torch.int64, device=masks.device)
    sizes.scatter_add_(1, flat, masks.reshape(n, -1).long())
    sizes[:, big] = 0
    keep = (flat == sizes.argmax(dim=1, keepdim=True)) & masks.reshape(n, -1)
    return keep.reshape(n, h, w)


def postprocess(probs: torch.Tensor, cc: bool) -> np.ndarray:
    """[z, H, W, C] probabilities -> [z, H, W] uint8 labels 1..C, the later
    channel winning, each label reduced to its largest component."""
    flat = torch.zeros(probs.shape[:-1], dtype=torch.uint8,
                       device=probs.device)
    for c in range(probs.shape[-1]):
        flat[probs[..., c] > 0.5] = c + 1
    if cc:
        out = torch.zeros_like(flat)
        for c in range(probs.shape[-1]):
            keep = largest_component(flat == c + 1)
            out = torch.where(keep, torch.tensor(c + 1, dtype=torch.uint8,
                                                 device=flat.device), out)
        flat = out
    return flat.cpu().numpy()


def undo_to(labels: np.ndarray, orig_shape_zyx, spacing_xyz,
            cfg: Dict, fill=0) -> np.ndarray:
    """Model-space labels [z, H, W] -> the study's [z, y, x] grid: centre
    pad/crop to the size the resampling gave, then nearest resampling from
    (SPACING, z spacing) to the study's spacing."""
    z, y, x = orig_shape_zyx
    cfg_xyz = (float(cfg["SPACING"][1]), float(cfg["SPACING"][0]),
               float(spacing_xyz[2]))
    new = resampled_size((x, y, z), spacing_xyz, cfg_xyz)
    mid = pad_crop(labels, list(reversed(new)), fill)
    return resample(mid, cfg_xyz, (x, y, z), spacing_xyz, nearest=True,
                    fill=fill)


@torch.no_grad()
def serve_study(cfg: Dict, weights: Dict[str, torch.Tensor],
                vol: np.ndarray, spacing_xyz, quant=None, device="cuda"):
    """The label map that serving one study should write, and the head's
    logits [C, z, y, x] taken through the same inverse steps (-1e4, sure
    background, where the model saw nothing)."""
    x = preprocess(vol, spacing_xyz[:2], cfg)
    fwd = Forward(cfg, quant=quant)
    z = fwd(weights, torch.as_tensor(x, device=device), train=False,
            logits=True)
    labels = postprocess(torch.sigmoid(z), bool(cfg.get("CC_FILTER")))
    zc = z.movedim(-1, 0).cpu().numpy()
    return (undo_to(labels, vol.shape, spacing_xyz, cfg),
            np.stack([undo_to(np.ascontiguousarray(c), vol.shape,
                              spacing_xyz, cfg, fill=-1e4) for c in zc]))
