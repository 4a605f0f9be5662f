"""Landmark detection and the live localisation metrics in torch —
counterpart of ``cmrtpu/eval/detection.py``.

Both strategies are batched reductions over [B, H, W, C] channels and return
(coords [B, C, 2] (y, x) float32, valid [B, C] bool), NaN where a slot has
no response above the threshold:

  * ``peaks_com``    — center of mass of the thresholded channel (the
                       reference's strategy);
  * ``peaks_argmax`` — coordinates of the channel's maximum response.

``localisation_metrics`` gives ``loc_mm``, ``loc_det`` and ``loc_fp`` as 0-d
tensors that stay on the device, so they ride every train and eval step.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from cmrtpu_torch import config as C


def peaks_com(heatmaps: torch.Tensor, threshold: float = 0.5):
    """Center-of-mass detection over [B, H, W, C] channels."""
    x = heatmaps.float()
    _, h, w, _ = x.shape
    mask = (x > threshold).float()
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :, None]
    total = mask.sum(dim=(1, 2))                              # [B, C]
    cy = (mask * ys).sum(dim=(1, 2)) / torch.clamp(total, min=1.0)
    cx = (mask * xs).sum(dim=(1, 2)) / torch.clamp(total, min=1.0)
    valid = total > 0
    coords = torch.stack([cy, cx], dim=-1)                    # [B, C, 2]
    coords = torch.where(valid[..., None], coords, float("nan"))
    return coords, valid


def peaks_argmax(heatmaps: torch.Tensor, threshold: float = 0.5):
    """Peak-response detection over [B, H, W, C] channels."""
    x = heatmaps.float()
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    idx = flat.argmax(dim=1)              # [B, C], first maximum on ties
    peak = flat.amax(dim=1)
    cy = torch.div(idx, w, rounding_mode="floor").float()
    cx = torch.remainder(idx, w).float()
    valid = peak > threshold
    coords = torch.stack([cy, cx], dim=-1)
    coords = torch.where(valid[..., None], coords, float("nan"))
    return coords, valid


def detect(heatmaps, strategy: str = "com", threshold: float = 0.5):
    """Strategy dispatcher: 'com' (reference parity) or 'argmax'."""
    if strategy == "argmax":
        return peaks_argmax(heatmaps, threshold=threshold)
    if strategy == "com":
        return peaks_com(heatmaps, threshold=threshold)
    raise ValueError(f"unknown detection strategy: {strategy}")


def localisation_metrics(config: Dict):
    """Training-time localisation metrics in mm (MONITOR_LOCALISATION).

      * ``loc_mm``  — mean localisation error over every slot (slice x
        channel) where the gt or the prediction detects a landmark: both ->
        their distance (gt CoM vs the detected peak), one side only (a missed
        landmark or a spurious detection) -> the distance to the farthest
        image corner; px -> mm with the in-plane SPACING.
      * ``loc_det`` — detected fraction of gt-present landmarks.
      * ``loc_fp``  — detections on gt-absent slots / gt-absent slots.

    Landmark channels are the trailing len(MASK_VALUES) channels; slots where
    neither side detects are left out."""
    spacing = float(np.mean(np.asarray(
        C.get(config, "SPACING", [1.2, 1.2]), np.float32)[-2:]))
    if not C.get(config, "RESAMPLE", True):
        logging.warning(
            "MONITOR_LOCALISATION with RESAMPLE=False: loc_mm uses the "
            "config SPACING (%.3g mm/px) as a NOMINAL scale — native "
            "per-study spacing varies, so absolute mm values are "
            "approximate (ranking/monitoring is still consistent)",
            spacing)
    strategy = str(C.get(config, "DETECTION_STRATEGY", "com") or "com").lower()
    n_fg = max(1, len(C.get(config, "MASK_VALUES", [1, 2]) or [1, 2]))

    def _pairs(y_true, y_pred):
        gt, gt_valid = peaks_com(y_true[..., -n_fg:])
        pr, pr_valid = detect(y_pred[..., -n_fg:], strategy=strategy)
        return (torch.nan_to_num(gt), gt_valid,
                torch.nan_to_num(pr), pr_valid)

    def loc_mm(y_true, y_pred):
        gt, gt_valid, pr, pr_valid = _pairs(y_true, y_pred)
        d = torch.sqrt(torch.sum((gt - pr) ** 2, dim=-1))     # [B, C] px
        h, w = y_true.shape[-3], y_true.shape[-2]

        def farthest_corner(coords):
            # the farther edge on each axis, with no corner table uploaded
            # (an upload waits for the card)
            r, c = coords[..., 0], coords[..., 1]
            return torch.sqrt(torch.maximum(r ** 2, (r - (h - 1.0)) ** 2)
                              + torch.maximum(c ** 2, (c - (w - 1.0)) ** 2))

        both = gt_valid & pr_valid
        ub = torch.where(gt_valid, farthest_corner(gt), farthest_corner(pr))
        either = gt_valid | pr_valid
        dist = torch.where(both, d, ub)
        n = either.sum()
        return (torch.where(either, dist, 0.0).sum()
                / torch.clamp(n, min=1)) * spacing

    def loc_det(y_true, y_pred):
        _, gt_valid, _, pr_valid = _pairs(y_true, y_pred)
        return ((gt_valid & pr_valid).sum()
                / torch.clamp(gt_valid.sum(), min=1)).float()

    def loc_fp(y_true, y_pred):
        _, gt_valid, _, pr_valid = _pairs(y_true, y_pred)
        absent = ~gt_valid
        return ((absent & pr_valid).sum()
                / torch.clamp(absent.sum(), min=1)).float()

    return {"loc_mm": loc_mm, "loc_det": loc_det, "loc_fp": loc_fp}
