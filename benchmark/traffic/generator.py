"""The one generator of the benchmark's inputs: short-axis phantoms made
from the seed, read by the parameters of a traffic file.

A slice is an LV blood pool, a myocardial ring and an RV crescent on a
blurred background with noise (labels RV=1, MYO=2, LV=3 as ACDC's); its
two RV insertion points, where the RV circle meets the MYO's outer circle,
are 3 x 3 labels 1 (anterior) and 2 (inferior). Rewritten from the port's
``tools/full_cv_demo.py:generate_cohort`` (per-patient centre, radii and
septum angle; ED and ES; radii shrinking toward the apex) and
``tools/cine_quality_demo.py`` (one volume of frames across the cycle per
slice position), batched on the device.

Kinds (``traffic["generator"]``):
  slices  -> cache (x [N, H, W] float32, y [N, H, W] uint8)
  cine    -> cache (x [N, T, H, W] float32, y [N, T, H, W] uint8)
  studies -> list of studies, each a raw int16 [z, y, x] stack with its
             spacing (x, y, z) and origin, at a scanner's own matrix
Sizes (slices a patient, slice positions, a study's slice count, matrix,
spacing and slice gap) come from ``traffic["size_seed"]``, the same for
every run seed, so each seed serves or trains on the same amount of work
in another order; the seed draws the order (a permutation of the
patients or studies), the anatomy and, from a device generator seeded
SEED + 3, the pixel noise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NOISE_STREAM = 3
CHUNK = 512


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of [N, H, W] (reflect border, truncate 4)."""
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).float().to(img.device)
    t = img[:, None]
    t = F.conv2d(F.pad(t, (r, r, 0, 0), mode="reflect"), k.reshape(1, 1, 1, -1))
    t = F.conv2d(F.pad(t, (0, 0, r, r), mode="reflect"), k.reshape(1, 1, -1, 1))
    return t[:, 0]


def _phantoms(p: Dict[str, np.ndarray], ny: int, nx: int,
              g: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images and RVIP label maps [N, ny, nx] of N slices, in pixels:
    p holds cy, cx, r_lv, t_myo, theta, r_rv, one entry a slice."""
    dev = g.device
    n = len(p["cy"])
    cy, cx = p["cy"], p["cx"]
    r1 = p["r_lv"] + p["t_myo"]
    rvy = cy + np.sin(p["theta"]) * (r1 + 0.45 * p["r_rv"])
    rvx = cx - np.cos(p["theta"]) * (r1 + 0.45 * p["r_rv"])
    # the two intersections of the MYO's outer circle and the RV circle
    d = np.hypot(rvy - cy, rvx - cx)
    a = (r1 ** 2 - p["r_rv"] ** 2 + d ** 2) / (2 * d)
    h = np.sqrt(np.maximum(r1 ** 2 - a ** 2, 0.0))
    uy, ux = (rvy - cy) / d, (rvx - cx) / d
    my, mx = cy + a * uy, cx + a * ux
    pts = np.stack([np.stack([my - h * ux, mx + h * uy], -1),
                    np.stack([my + h * ux, mx - h * uy], -1)], 1)  # [N,2,2]
    order = np.argsort(pts[:, :, 0], axis=1)  # anterior: the smaller y
    pts = np.take_along_axis(pts, order[:, :, None], axis=1)

    t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)[:, None, None]
         for k, v in dict(cy=cy, cx=cx, r_lv=p["r_lv"], r1=r1, rvy=rvy,
                          rvx=rvx, r_rv=p["r_rv"]).items()}
    yy = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(nx, dtype=torch.float32, device=dev)[None, None, :]
    d_lv = torch.hypot(yy - t["cy"], xx - t["cx"])
    d_rv = torch.hypot(yy - t["rvy"], xx - t["rvx"])
    img = torch.full((n, ny, nx), 120.0, device=dev)
    img = torch.where(d_rv <= t["r_rv"], 380.0, img)
    img = torch.where((d_lv > t["r_lv"]) & (d_lv <= t["r1"]), 200.0, img)
    img = torch.where(d_lv <= t["r_lv"], 420.0, img)
    img = _blur(img, 1.5) + 25.0 * torch.randn((n, ny, nx), generator=g,
                                               device=dev)
    lab = torch.zeros((n, ny, nx), dtype=torch.uint8, device=dev)
    ij = torch.as_tensor(np.rint(pts), dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)
    for k, value in ((0, 1), (1, 2)):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                yi = (ij[:, k, 0] + dy).clamp(0, ny - 1)
                xi = (ij[:, k, 1] + dx).clamp(0, nx - 1)
                lab[rows, yi, xi] = value
    return img, lab


def _patients(rng, n: int, hw: float) -> Dict[str, np.ndarray]:
    jit = max(1, int(hw * 0.06))
    return dict(cy=hw / 2 + rng.integers(-jit, jit + 1, n),
                cx=hw / 2 + rng.integers(-jit, jit + 1, n),
                r_lv0=hw * rng.uniform(0.11, 0.15, n),
                t_myo=hw * rng.uniform(0.035, 0.055, n),
                theta=rng.uniform(-0.5, 0.5, n))


def _slice_params(pat: Dict[str, np.ndarray], patient: np.ndarray,
                  z: np.ndarray, lv_scale: np.ndarray,
                  rng) -> Dict[str, np.ndarray]:
    """One entry a slice: patient index, position toward the apex and the
    LV's scale in the cycle."""
    zs = 1.0 - 0.035 * z
    return dict(cy=pat["cy"][patient].astype(np.float64),
                cx=pat["cx"][patient].astype(np.float64),
                r_lv=pat["r_lv0"][patient] * lv_scale * zs,
                t_myo=pat["t_myo"][patient] * zs,
                theta=pat["theta"][patient] + rng.normal(0, 0.03, len(z)),
                r_rv=pat["r_lv0"][patient] * 0.95 * zs)


def _chunks(p: Dict[str, np.ndarray], ny: int, nx: int, g):
    n = len(p["cy"])
    xs, ys = [], []
    for s in range(0, n, CHUNK):
        img, lab = _phantoms({k: v[s:s + CHUNK] for k, v in p.items()}, ny,
                             nx, g)
        xs.append(img.cpu().numpy())
        ys.append(lab.cpu().numpy())
    return np.concatenate(xs), np.concatenate(ys)


def _sizes(traffic: Dict, seed: int):
    """(rng of the seed, rng of the traffic's fixed sizes)."""
    return (np.random.default_rng(seed),
            np.random.default_rng(int(traffic.get("size_seed", 0))))


def slices(traffic: Dict, dim, seed: int, device):
    """A fold's training slices: patients x (ED, ES) x 8-12 slices."""
    rng, fixed = _sizes(traffic, seed)
    hw = int(dim[-1])
    n_pat = int(traffic["patients"])
    pat = _patients(rng, n_pat, hw)
    lo, hi = traffic["slices"]
    counts = rng.permutation(fixed.integers(lo, hi + 1, n_pat))
    patient, z, scale = [], [], []
    for i, c in enumerate(counts):
        for frame_scale in traffic["frame_scales"]:
            patient += [i] * c
            z += list(range(c))
            scale += [frame_scale] * c
    p = _slice_params(pat, np.asarray(patient), np.asarray(z, float),
                      np.asarray(scale, float), rng)
    g = torch.Generator(device).manual_seed(seed + NOISE_STREAM)
    return _chunks(p, int(dim[-2]), hw, g)


def cine(traffic: Dict, dim, seed: int, device):
    """Cine volumes [T, H, W]: one per slice position of every patient,
    the LV's scale following the cycle from ED (1.0) to ES (the last
    frame scale) and back."""
    rng, fixed = _sizes(traffic, seed)
    frames, hw = int(dim[0]), int(dim[-1])
    n_pat = int(traffic["patients"])
    pat = _patients(rng, n_pat, hw)
    lo, hi = traffic["positions"]
    counts = rng.permutation(fixed.integers(lo, hi + 1, n_pat))
    es = float(traffic["frame_scales"][-1])
    cycle = 1.0 - (1.0 - es) * np.sin(np.pi * np.arange(frames) / frames) ** 2
    patient = np.repeat(np.arange(n_pat), counts * frames)
    z = np.concatenate([np.repeat(np.arange(c), frames) for c in counts])
    scale = np.tile(cycle, int(counts.sum()))
    p = _slice_params(pat, patient, z.astype(float), scale, rng)
    g = torch.Generator(device).manual_seed(seed + NOISE_STREAM)
    x, y = _chunks(p, int(dim[-2]), hw, g)
    return (x.reshape(-1, frames, *x.shape[1:]),
            y.reshape(-1, frames, *y.shape[1:]))


def studies(traffic: Dict, seed: int, device) -> List[Dict]:
    """Raw studies as a scanner writes them: z slices of a matrix and
    spacing drawn per study, int16 intensities."""
    rng, fixed = _sizes(traffic, seed)
    n = int(traffic["studies"])
    sizes = list(zip(fixed.integers(traffic["z"][0], traffic["z"][1] + 1, n),
                     fixed.integers(traffic["matrix"][0],
                                    traffic["matrix"][1] + 1, n),
                     fixed.integers(traffic["matrix"][0],
                                    traffic["matrix"][1] + 1, n),
                     fixed.uniform(*traffic["spacing"], n),
                     fixed.uniform(*traffic["slice_gap"], n)))
    out = []
    g = torch.Generator(device).manual_seed(seed + NOISE_STREAM)
    for k in rng.permutation(n):
        z, ny, nx = (int(v) for v in sizes[k][:3])
        s, gap = float(sizes[k][3]), float(sizes[k][4])
        mm = traffic["field_mm"]  # the phantom's field, in mm, as 224 px
        pat = _patients(rng, 1, mm / s)
        pat["cy"] = pat["cy"] - mm / s / 2 + ny / 2
        pat["cx"] = pat["cx"] - mm / s / 2 + nx / 2
        p = _slice_params(pat, np.zeros(z, int), np.arange(z, dtype=float),
                          np.full(z, 1.0), rng)
        img, _ = _phantoms(p, ny, nx, g)
        vol = torch.clamp(torch.round(img), 0, 32767).to(torch.int16)
        origin = tuple(float(v) for v in rng.uniform(-150, 150, 3))
        out.append(dict(array=vol.cpu().numpy(), spacing=(s, s, gap),
                        origin=origin))
    return out
