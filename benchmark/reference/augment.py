"""Plain augmentation and training targets, frozen from the port's
``pipeline/augment.py`` and ``finalize_batch`` as of the benchmark's first
commit, so a later change to the program cannot move the yardstick.

The albumentations chain of the reference (RandomRotate90 p=0.2, then
ShiftScaleRotate with shift only, GridDistortion and Downscale, each behind
AUGMENT_PROB) is a separable coordinate map per axis: one bilinear gather
for images, one nearest gather for masks, with OpenCV's BORDER_REFLECT_101.
The draws come from a ``torch.Generator`` in the order the program draws
them, so the same generator state gives the same warps.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

GRID_STEPS = 5
DISTORT_LIMIT = 0.3
SHIFT_LIMIT = 0.025
DOWNSCALE = 0.9
ROT90_P = 0.2
EPS = float(np.finfo(np.float32).eps)


def _uniform(g: torch.Generator, shape, low: float, high: float):
    return low + (high - low) * torch.rand(shape, generator=g,
                                           device=g.device)


def draw_params(g: torch.Generator, cfg: Dict, batch: int) -> Dict:
    prob = float(cfg.get("AUGMENT_PROB", 0.8))
    compose_on = _uniform(g, (batch,), 0.0, 1.0) < prob

    def gate(p, key):
        on = _uniform(g, (batch,), 0.0, 1.0) < p
        return compose_on & on & bool(cfg.get(key, False))

    rot_on = gate(ROT90_P, "RANDOMROTATE")
    rot_k = torch.randint(0, 4, (batch,), generator=g, device=g.device)
    out = {"rot_k": torch.where(rot_on, rot_k, 0)}
    out["ssr_on"] = gate(prob, "SHIFTSCALEROTATE")
    out["shift"] = _uniform(g, (batch, 2), -SHIFT_LIMIT, SHIFT_LIMIT)
    out["gd_on"] = gate(prob, "GRIDDISTORTION")
    out["gd_factors"] = 1.0 + _uniform(g, (batch, 2, GRID_STEPS),
                                       -DISTORT_LIMIT, DISTORT_LIMIT)
    out["down_on"] = gate(prob, "DOWNSCALE")
    if int(cfg.get("BORDER_MODE", 4)) != 4:
        raise NotImplementedError("the reference warps with BORDER_MODE 4")
    return out


def _reflect101(c, size: int):
    period = 2.0 * (size - 1)
    c = torch.remainder(c.abs(), period)
    return torch.where(c > size - 1, period - c, c)


def _axis_coords(params: Dict, axis: int, size: int, batch: int, device):
    c = torch.arange(size, dtype=torch.float32, device=device).expand(batch,
                                                                      size)
    m = max(1, int(round(size * DOWNSCALE)))
    mid = torch.floor((c + 0.5) * (m / size))
    down = torch.clamp(torch.floor((mid + 0.5) * (size / m)), 0, size - 1)
    c = torch.where(params["down_on"][:, None], down, c)
    if size >= GRID_STEPS:
        step = size // GRID_STEPS
        widths = torch.full((GRID_STEPS,), float(step), device=device)
        widths[-1] = float(size - step * (GRID_STEPS - 1))
        seg = widths * params["gd_factors"][:, axis]
        ends = torch.cumsum(seg, dim=-1)
        starts = ends - seg
        pos = torch.arange(size, device=device)
        idx = torch.clamp(torch.div(pos, step, rounding_mode="floor"),
                          max=GRID_STEPS - 1)
        table = starts[:, idx] + (pos - idx * step) / widths[idx] * seg[:, idx]
        cc = torch.clamp(c, 0, size - 1)
        lo = torch.floor(cc).long()
        hi = torch.clamp(lo + 1, max=size - 1)
        w = cc - lo
        warped = (torch.gather(table, 1, lo) * (1.0 - w)
                  + torch.gather(table, 1, hi) * w)
        c = torch.where(params["gd_on"][:, None], warped, c)
    c = torch.where(params["ssr_on"][:, None],
                    c - params["shift"][:, axis:axis + 1] * size, c)
    return _reflect101(c, size)


def _rows(f, idx):
    return torch.gather(f, 1, idx[:, :, None].expand(-1, -1, f.shape[2]))


def _cols(f, idx):
    return torch.gather(f, 2, idx[:, None, :].expand(-1, f.shape[1], -1))


def _warp(img, ys, xs, nearest: bool):
    h, w = img.shape[-2], img.shape[-1]
    if nearest:
        iy = torch.clamp(torch.round(ys).long(), 0, h - 1)
        ix = torch.clamp(torch.round(xs).long(), 0, w - 1)
        return _cols(_rows(img, iy), ix)
    f = img.float()
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    wy, wx = ys - y0, xs - x0
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    top = _rows(f, y0) * (1 - wy)[:, :, None] + _rows(f, y1) * wy[:, :, None]
    return (_cols(top, x0) * (1 - wx)[:, None, :]
            + _cols(top, x1) * wx[:, None, :])


def apply_params(params: Dict, imgs: torch.Tensor, msks: torch.Tensor):
    """Images and label maps [B, H, W] or [B, T, H, W]: every plane of an
    example gets the example's rot90 and warp."""
    b, h, w = imgs.shape[0], imgs.shape[-2], imgs.shape[-1]
    per = imgs[0].numel() // (h * w)
    fi = imgs.reshape(b * per, h, w)
    fm = msks.reshape(b * per, h, w)
    if h == w:
        k = params["rot_k"].repeat_interleave(per)
        pick = torch.arange(fi.shape[0], device=fi.device)
        fi = torch.stack([torch.rot90(fi, r, dims=(-2, -1))
                          for r in range(4)])[k, pick]
        fm = torch.stack([torch.rot90(fm, r, dims=(-2, -1))
                          for r in range(4)])[k, pick]
    ys = _axis_coords(params, 0, h, b, imgs.device).repeat_interleave(per, 0)
    xs = _axis_coords(params, 1, w, b, imgs.device).repeat_interleave(per, 0)
    return (_warp(fi, ys, xs, False).reshape(imgs.shape),
            _warp(fm, ys, xs, True).reshape(msks.shape))


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's kernel: radius int(truncate * sigma + 0.5)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter of each [H, W] plane of [N, H, W]
    (mode 'reflect' = symmetric padding), along W and then H."""
    k = torch.from_numpy(gaussian_kernel1d(sigma)).to(planes.device)
    r = (k.numel() - 1) // 2
    x = planes.float()[:, None]
    x = F.conv2d(_sym_pad(x, r, -1), k.reshape(1, 1, 1, -1))
    x = F.conv2d(_sym_pad(x, r, -2), k.reshape(1, 1, -1, 1))
    return x[:, 0]


def _sym_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    i = torch.remainder(torch.arange(-r, n + r, device=x.device), 2 * n)
    return x.index_select(dim, torch.where(i < n, i, 2 * n - 1 - i))


def targets(imgs: torch.Tensor, msks: torch.Tensor, cfg: Dict):
    """(x [B, *DIM, 1], y [B, *DIM, C]): per-example MinMax images, one
    binary channel per MASK_VALUES entry, blurred (GAUS, SIGMA) and
    min-max normalised jointly per example."""
    b = imgs.shape[0]
    flat = imgs.float().reshape(b, -1)
    lo, hi = flat.amin(1, keepdim=True), flat.amax(1, keepdim=True)
    x = ((flat - lo) / (hi - lo + EPS)).reshape(imgs.shape)[..., None]
    y = torch.stack([msks == v for v in cfg["MASK_VALUES"]], dim=1).float()
    if cfg.get("GAUS"):
        h, w = y.shape[-2], y.shape[-1]
        y = blur(y.reshape(-1, h, w), float(cfg["SIGMA"])).reshape(y.shape)
        f = y.reshape(b, -1)
        lo, hi = f.amin(1, keepdim=True), f.amax(1, keepdim=True)
        y = ((f - lo) / (hi - lo + EPS)).reshape(y.shape)
    return x, torch.movedim(y, 1, -1)
