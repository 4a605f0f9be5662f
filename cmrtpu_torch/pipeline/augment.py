"""Batched on-device augmentation in torch — counterpart of
``cmrtpu/pipeline/augment.py`` (the albumentations replacement).

The reference's RandomRotate90 / ShiftScaleRotate(shift only) /
GridDistortion / Downscale chain (ref: src/data/Preprocess.py:382-422) has a
separable coordinate map per axis, so it composes into one coordinate vector
per axis and example, then one bilinear (image) / nearest (mask) gather with
the configured border.

Drawing and applying are split: ``draw_params`` draws every example's
parameters from an explicit ``torch.Generator`` (on the card for a CUDA
generator); ``apply_params`` is deterministic, so the tests hand it the
parameters cmrtpu drew and compare the warps. Gates as in the reference: an
outer gate at AUGMENT_PROB, then inner gates at AUGMENT_PROB (shift, grid
distortion, downscale) and ROT90_P = 0.2 (rot90).

An example is one [H, W] slice or a [T, H, W] cine volume (with HEADS a
head axis before the mask's spatial axes); every [H, W] plane of an example
gets that example's one draw, as ReplayCompose's additional_targets and
cmrtpu's warp of ``[..., H, W]`` do.
"""

from __future__ import annotations

from typing import Dict

import torch

from cmrtpu_torch import config as C

GRID_STEPS = 5          # albumentations GridDistortion default num_steps
DISTORT_LIMIT = 0.3     # default distort_limit
SHIFT_LIMIT = 0.025     # ref: ShiftScaleRotate(shift_limit=0.025)
DOWNSCALE = 0.9         # ref: Downscale(scale_min=0.9, scale_max=0.9)
ROT90_P = 0.2           # ref: RandomRotate90(p=0.2)


def _uniform(generator: torch.Generator, shape, low: float, high: float):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def draw_params(generator: torch.Generator, config: Dict,
                batch: int) -> Dict:
    """One transform draw per example (ReplayCompose parity) for a batch of
    ``batch`` examples, on the generator's device. The grid-distortion
    factors 1 + U(-0.3, 0.3) are drawn here, 5 per axis: [B, 2, 5]."""
    prob = float(C.get(config, "AUGMENT_PROB", 0.8))
    compose_on = _uniform(generator, (batch,), 0.0, 1.0) < prob

    def gate(p, key):
        on = _uniform(generator, (batch,), 0.0, 1.0) < p
        return compose_on & on & bool(C.get(config, key, False))

    rot_on = gate(ROT90_P, "RANDOMROTATE")
    rot_k = torch.randint(0, 4, (batch,), generator=generator,
                          device=generator.device)
    mode = C.get(config, "BORDER_MODE", 4)
    return {
        "rot_k": torch.where(rot_on, rot_k, 0),
        "ssr_on": gate(prob, "SHIFTSCALEROTATE"),
        "shift": _uniform(generator, (batch, 2), -SHIFT_LIMIT, SHIFT_LIMIT),
        "gd_on": gate(prob, "GRIDDISTORTION"),
        "gd_factors": 1.0 + _uniform(generator, (batch, 2, GRID_STEPS),
                                     -DISTORT_LIMIT, DISTORT_LIMIT),
        "down_on": gate(prob, "DOWNSCALE"),
        "border_mode": 4 if mode is None else int(mode),
        "border_value": float(C.get(config, "BORDER_VALUE", 0) or 0.0),
    }


def _reflect101(coords, size: int):
    """OpenCV BORDER_REFLECT_101 coordinate folding (gdcba|abcdefgh|gfedc)."""
    if size == 1:
        return torch.zeros_like(coords)
    period = 2.0 * (size - 1)
    c = torch.remainder(coords.abs(), period)
    return torch.where(c > size - 1, period - c, c)


def _fold_coords(coords, size: int, mode: int):
    """Map out-of-range source coordinates per the OpenCV border mode
    (0=constant, 1=replicate, 2=reflect, 3=wrap, 4=reflect101). Constant
    fill happens at the gather; here it clamps."""
    if mode in (0, 1):
        return torch.clamp(coords, 0.0, size - 1.0)
    if mode == 2:  # edge-repeating reflect: fold around -0.5 / size-0.5
        period = 2.0 * size
        c = torch.remainder(coords + 0.5, period)
        c = torch.where(c > size, period - c, c) - 0.5
        return torch.clamp(c, 0.0, size - 1.0)
    if mode == 3:  # wrap
        return torch.remainder(coords, size)
    return _reflect101(coords, size)


def _downscale_map(coords, size: int, active):
    """Pullback of nearest-down (to round(size*0.9)) + nearest-up."""
    m = max(1, int(round(size * DOWNSCALE)))
    mid = torch.floor((coords + 0.5) * (m / size))
    src = torch.floor((mid + 0.5) * (size / m))
    src = torch.clamp(src, 0, size - 1)
    return torch.where(active[:, None], src, coords)


def _grid_distortion_table(factors, size: int):
    """Monotone piecewise-linear dst->src axis maps [B, size] from per-cell
    scale factors [B, 5], linear within each of the 5 cells."""
    step = size // GRID_STEPS
    # the last cell takes the remainder; built on the device, as an item
    # written from the host would wait for the card
    cells = torch.arange(GRID_STEPS, device=factors.device)
    widths = torch.where(cells == GRID_STEPS - 1,
                         float(size - step * (GRID_STEPS - 1)), float(step))
    seg = widths * factors
    ends = torch.cumsum(seg, dim=-1)
    starts = ends - seg
    pos = torch.arange(size, device=factors.device)
    idx = torch.clamp(torch.div(pos, step, rounding_mode="floor"),
                      max=GRID_STEPS - 1)
    frac = (pos - idx * step) / widths[idx]
    return starts[:, idx] + frac * seg[:, idx]


def _eval_table(table, coords, size: int):
    """Evaluate tabulated axis maps [B, size] at fractional coordinates."""
    c = torch.clamp(coords, 0, size - 1)
    lo = torch.floor(c).long()
    hi = torch.clamp(lo + 1, max=size - 1)
    w = c - lo
    return (torch.gather(table, 1, lo) * (1.0 - w)
            + torch.gather(table, 1, hi) * w)


def _axis_coords(params: Dict, axis: int, size: int, batch: int, device):
    """Compose downscale -> grid-distortion -> shift pullbacks for one axis.
    Returns (folded coords for gathering, raw coords for constant fill)."""
    coords = torch.arange(size, dtype=torch.float32,
                          device=device).expand(batch, size)
    coords = _downscale_map(coords, size, params["down_on"])
    if size >= GRID_STEPS:  # distortion undefined below one cell per step
        table = _grid_distortion_table(params["gd_factors"][:, axis], size)
        distorted = _eval_table(table, coords, size)
        coords = torch.where(params["gd_on"][:, None], distorted, coords)
    coords = torch.where(params["ssr_on"][:, None],
                         coords - params["shift"][:, axis:axis + 1] * size,
                         coords)
    return _fold_coords(coords, size, params["border_mode"]), coords


def _rows(f, idx):
    """f [B, H, W] gathered at row indices idx [B, H'] -> [B, H', W]."""
    return torch.gather(f, 1, idx[:, :, None].expand(-1, -1, f.shape[2]))


def _cols(f, idx):
    """f [B, H, W] gathered at column indices idx [B, W'] -> [B, H, W']."""
    return torch.gather(f, 2, idx[:, None, :].expand(-1, f.shape[1], -1))


def _warp2d(img, ys, xs, nearest: bool, raw_ys, raw_xs, border_mode: int,
            fill: float):
    """Separable gather of [B, H, W] at (ys [B, H] x xs [B, W]). For
    BORDER_CONSTANT (mode 0) the raw coordinates drive tap-level masking so
    out-of-range taps blend with ``fill`` like cv2.remap."""
    h, w = img.shape[-2], img.shape[-1]
    constant = border_mode == 0
    wrap = border_mode == 3

    if nearest:
        iy = torch.round(ys).long()
        ix = torch.round(xs).long()
        iy = torch.remainder(iy, h) if wrap else torch.clamp(iy, 0, h - 1)
        ix = torch.remainder(ix, w) if wrap else torch.clamp(ix, 0, w - 1)
        out = _cols(_rows(img, iy), ix)
        if constant:
            ry, rx = torch.round(raw_ys), torch.round(raw_xs)
            oob = ((ry < 0) | (ry > h - 1))[:, :, None] \
                | ((rx < 0) | (rx > w - 1))[:, None, :]
            out = torch.where(oob, fill, out)
        return out

    f = img.float()
    if constant:
        ry0 = torch.floor(raw_ys).long()
        wy = raw_ys - ry0
        rx0 = torch.floor(raw_xs).long()
        wx = raw_xs - rx0

        def row(idx):
            valid = (idx >= 0) & (idx <= h - 1)
            taken = _rows(f, torch.clamp(idx, 0, h - 1))
            return torch.where(valid[:, :, None], taken, fill)

        top = row(ry0) * (1 - wy)[:, :, None] + row(ry0 + 1) * wy[:, :, None]

        def col(rows, idx):
            valid = (idx >= 0) & (idx <= w - 1)
            taken = _cols(rows, torch.clamp(idx, 0, w - 1))
            return torch.where(valid[:, None, :], taken, fill)

        return (col(top, rx0) * (1 - wx)[:, None, :]
                + col(top, rx0 + 1) * wx[:, None, :])

    y0 = torch.floor(ys).long()
    wy = ys - y0
    x0 = torch.floor(xs).long()
    wx = xs - x0
    if wrap:  # the hi tap crosses the modular boundary
        y1 = torch.remainder(y0 + 1, h)
        x1 = torch.remainder(x0 + 1, w)
    else:
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
    top = _rows(f, y0) * (1 - wy)[:, :, None] + _rows(f, y1) * wy[:, :, None]
    return (_cols(top, x0) * (1 - wx)[:, None, :]
            + _cols(top, x1) * wx[:, None, :])


def _planes(x: torch.Tensor):
    """x [B, ..., H, W] -> ([B * P, H, W], P): an example's P planes in a
    row."""
    b, h, w = x.shape[0], x.shape[-2], x.shape[-1]
    per = 1
    for d in x.shape[1:-2]:
        per *= d
    return x.reshape(b * per, h, w), per


def apply_params(params: Dict, imgs: torch.Tensor, msks: torch.Tensor):
    """Augment a batch of examples with drawn parameters: images [B, H, W]
    or [B, T, H, W], masks of the same shape or with a head axis after B
    ([B, n_heads, ...]). Every plane of an example, image and masks, gets
    the example's rot90 (square inputs only), then one composed warp per
    axis."""
    if imgs.dim() not in (3, 4):
        raise ValueError(f"images must be [B, H, W] or [B, T, H, W], got "
                         f"{tuple(imgs.shape)}")
    b, h, w = imgs.shape[0], imgs.shape[-2], imgs.shape[-1]
    flat_i, per_img = _planes(imgs)
    flat_m, per_msk = _planes(msks)
    if h == w:  # RandomRotate90 (exact, square inputs only)
        k = params["rot_k"]
        flat_i = _rot90(flat_i, k.repeat_interleave(per_img))
        flat_m = _rot90(flat_m, k.repeat_interleave(per_msk))
    ys, raw_ys = _axis_coords(params, 0, h, b, imgs.device)
    xs, raw_xs = _axis_coords(params, 1, w, b, imgs.device)
    mode, fill = params["border_mode"], params["border_value"]

    def warp(flat, per, nearest):
        return _warp2d(flat, *(t.repeat_interleave(per, dim=0)
                               for t in (ys, xs)), nearest,
                       *(t.repeat_interleave(per, dim=0)
                         for t in (raw_ys, raw_xs)), mode, fill)

    return (warp(flat_i, per_img, False).reshape(imgs.shape),
            warp(flat_m, per_msk, True).reshape(msks.shape))


def _rot90(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rotate each [H, W] slice of x [N, H, W] by its own k quarter turns."""
    pick = torch.arange(x.shape[0], device=x.device)
    return torch.stack([torch.rot90(x, r, dims=(-2, -1))
                        for r in range(4)])[k, pick]
