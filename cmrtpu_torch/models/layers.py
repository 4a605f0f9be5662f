"""Reusable layers beyond the U-Net blocks — counterpart of
``cmrtpu/models/layers.py``: interpolating 3D upsampling, in-plane
resizing, the spatial-transformer helpers and the resizing 2D-in-3D
wrapper.

Layouts follow the JAX package: volumes are [B, D, H, W, C] and images
[..., H, W, C], channels last. The resizes reproduce ``jax.image.resize``:
half-pixel centres, and for 'bilinear' a triangle kernel that widens when
it downsamples (antialiasing), which is ``F.interpolate(...,
align_corners=False, antialias=True)``; 'nearest' picks the source pixel
whose centre is nearest, ``mode='nearest-exact'``. ``jax.image.resize``'s
cubic and Lanczos kernels have no torch counterpart here and raise.

``euler_angles_to_rotation_matrix`` and ``affine_matrix_inverter`` are the
port's own copies of cmrtpu's numpy helpers (their module imports JAX).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _resize_hw(x: torch.Tensor, size: Tuple[int, int],
               method: str) -> torch.Tensor:
    """Resize [N, C, H, W] to ``size`` as ``jax.image.resize`` does."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if method in ("bilinear", "linear"):
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=True)
    if method == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest-exact")
    raise ValueError(f"resize method {method!r}: the port resizes "
                     "'bilinear' or 'nearest'")


def resize_inplane(x: torch.Tensor, size: Tuple[int, int],
                   method: str = "bilinear") -> torch.Tensor:
    """Resize the trailing spatial (y, x) axes of a [..., H, W, C]
    tensor."""
    *lead, h, w, c = x.shape
    flat = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = _resize_hw(flat, size, method).permute(0, 2, 3, 1)
    return out.reshape(*lead, *size, c)


def upsample_3d_interpol(x: torch.Tensor,
                         size: Tuple[int, int, int] = (1, 2, 2),
                         method: str = "bilinear") -> torch.Tensor:
    """Upsample a [B, D, H, W, C] volume by integer factors: nearest (a
    repeat) along z, ``method`` in plane."""
    b, d, h, w, c = x.shape
    fz, fy, fx = (int(f) for f in size)
    if fz != 1:
        x = x.repeat_interleave(fz, dim=1)
    if fy == 1 and fx == 1:
        return x
    return resize_inplane(x, (h * fy, w * fx), method)


def euler_to_affine_matrix(theta: torch.Tensor, learnable_x: bool = True,
                           learnable_y: bool = True,
                           learnable_z: bool = True,
                           learnable_translation: bool = True,
                           learnable_scaling: bool = False) -> torch.Tensor:
    """[B, >=3] euler parameters (rx, ry, rz, tx, ty, tz, sx, sy, sz) ->
    flattened (3, 4) affine matrices [B, 12]: rotation Rz @ Ry @ Rx (each
    axis only when learnable), the scaling ADDED to the rotation block and
    the translation as the fourth column, as cmrtpu's layer."""
    e1, e2, e3 = theta[:, 0], theta[:, 1], theta[:, 2]
    one, zero = torch.ones_like(e1), torch.zeros_like(e1)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], dim=1)

    eye = mat([[one, zero, zero], [zero, one, zero], [zero, zero, one]])
    c1, s1, c2, s2, c3, s3 = (torch.cos(e1), torch.sin(e1), torch.cos(e2),
                              torch.sin(e2), torch.cos(e3), torch.sin(e3))
    rx = mat([[one, zero, zero], [zero, c1, s1], [zero, -s1, c1]])
    ry = mat([[c2, zero, -s2], [zero, one, zero], [s2, zero, c2]])
    rz = mat([[c3, s3, zero], [-s3, c3, zero], [zero, zero, one]])
    rot = (rz if learnable_z else eye) @ (ry if learnable_y else eye) @ \
        (rx if learnable_x else eye)
    if learnable_scaling:
        rot = rot + torch.diag_embed(theta[:, 6:9])
    if learnable_translation:
        translation = theta[:, 3:6, None]
    else:
        translation = torch.zeros(theta.shape[0], 3, 1, dtype=theta.dtype,
                                  device=theta.device)
    return torch.cat([rot, translation], dim=2).reshape(theta.shape[0], 12)


def invert_affine_matrix(m: torch.Tensor) -> torch.Tensor:
    """Invert a batch of flattened (3, 4) affines [B, 12] through their
    homogeneous (4, 4) extension, in float32."""
    b = m.shape[0]
    mat = m.reshape(b, 3, 4).float()
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], device=m.device).expand(b, 1, 4)
    inv = torch.linalg.inv(torch.cat([mat, row], dim=1))
    return inv[:, :3, :].reshape(b, 12).to(m.dtype)


def euler_angles_to_rotation_matrix(theta: Sequence[float]) -> np.ndarray:
    """numpy: euler angles -> 3x3 rotation matrix, Rz @ Ry @ Rx."""
    rx = np.array([[1, 0, 0],
                   [0, np.cos(theta[0]), -np.sin(theta[0])],
                   [0, np.sin(theta[0]), np.cos(theta[0])]])
    ry = np.array([[np.cos(theta[1]), 0, np.sin(theta[1])],
                   [0, 1, 0],
                   [-np.sin(theta[1]), 0, np.cos(theta[1])]])
    rz = np.array([[np.cos(theta[2]), -np.sin(theta[2]), 0],
                   [np.sin(theta[2]), np.cos(theta[2]), 0],
                   [0, 0, 1]])
    return rz @ ry @ rx


def affine_matrix_inverter(m: np.ndarray) -> np.ndarray:
    """numpy: invert one flattened (3, 4) affine."""
    mat = np.asarray(m, np.float64).reshape(3, 4)
    square = np.concatenate([mat, [[0.0, 0.0, 0.0, 1.0]]], axis=0)
    return np.linalg.inv(square)[:3, :].reshape(12)


class ScaleLayer(nn.Module):
    """A single learnable scalar multiplier (param ``scale``, init 1)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class UnetWrapper(nn.Module):
    """Run a 2D model (``unet``: [N, H, W, C] -> [N, H, W, C']) over the z
    axis of a [B, Z, H, W, C] volume, z folded into the batch, with the
    in-plane resize to ``unet_inplane`` and back when ``resize``."""

    def __init__(self, unet: nn.Module,
                 unet_inplane: Tuple[int, int] = (224, 224),
                 resize: bool = True):
        super().__init__()
        self.unet = unet
        self.unet_inplane = tuple(unet_inplane)
        self.resize = resize

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, z, h, w, c = x.shape
        flat = x.reshape(b * z, h, w, c)
        if self.resize:
            flat = resize_inplane(flat, self.unet_inplane)
        out = self.unet(flat, generator=generator)
        if self.resize:
            out = resize_inplane(out, (h, w))
        return out.reshape(b, z, h, w, out.shape[-1])
