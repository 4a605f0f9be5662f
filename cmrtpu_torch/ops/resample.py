"""ITK-compatible separable resampling on the host (numpy) — the port's copy
of ``cmrtpu/ops/resample.py`` without its JAX twins.

The reference resamples with ``sitk.ResampleImageFilter`` configured with the
*input* image's direction and origin (ref: src/data/Preprocess.py:182-227).
With output direction == input direction and equal origins, the physical
out->in index map reduces to a pure per-axis diagonal scale,

    in_index_k = out_index_k * out_spacing_k / in_spacing_k,

independently of the direction matrix (it cancels). Resampling is therefore a
separable 1D gather per axis.

Interpolation parity with ITK:
  * linear — continuous indices inside [-0.5, size-0.5) interpolate between
    clamped neighbours; outside produces the default value 0.
  * nearest — ITK's RoundHalfIntegerUp, i.e. floor(c + 0.5).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

LINEAR = 2   # sitk.sitkLinear enum parity (config IMG_INTERPOLATION)
NEAREST = 1  # sitk.sitkNearestNeighbor enum parity (config MSK_INTERPOLATION)


def _axis_coords(out_size: int, out_spacing: float, in_spacing: float) -> np.ndarray:
    return np.arange(out_size, dtype=np.float64) * (out_spacing / in_spacing)


def _axis_gather_np(arr: np.ndarray, axis: int, coords: np.ndarray,
                    interpolate: int) -> np.ndarray:
    size = arr.shape[axis]
    inside = (coords >= -0.5) & (coords < size - 0.5)
    if interpolate == NEAREST:
        idx = np.floor(coords + 0.5).astype(np.int64)
        idx = np.clip(idx, 0, size - 1)
        out = np.take(arr, idx, axis=axis)
    else:
        c = np.clip(coords, 0.0, size - 1.0)
        lo = np.floor(c).astype(np.int64)
        hi = np.minimum(lo + 1, size - 1)
        w = (c - lo).astype(arr.dtype if np.issubdtype(arr.dtype, np.floating) else np.float64)
        a_lo = np.take(arr, lo, axis=axis).astype(np.float64)
        a_hi = np.take(arr, hi, axis=axis).astype(np.float64)
        shape = [1] * arr.ndim
        shape[axis] = len(coords)
        w = w.reshape(shape)
        out = a_lo * (1.0 - w) + a_hi * w
    mask_shape = [1] * arr.ndim
    mask_shape[axis] = len(coords)
    return np.where(inside.reshape(mask_shape), out, 0)


def resample_nd(array: np.ndarray, in_spacing_xyz: Sequence[float],
                out_size_xyz: Sequence[int], out_spacing_xyz: Sequence[float],
                interpolate: int = NEAREST) -> np.ndarray:
    """Resample a [(t,)z,y,x]-ordered array; size/spacing args in x,y,z order.

    Matches ``resample_3D`` semantics (ref: src/data/Preprocess.py:182-227);
    non-spatial leading axes beyond len(out_size) are preserved.
    """
    ndim_spatial = len(out_size_xyz)
    assert ndim_spatial <= array.ndim
    out = np.asarray(array)
    # axes: x,y,z (sitk order) map to numpy axes -1,-2,-3
    for k in range(ndim_spatial):
        axis = array.ndim - 1 - k
        coords = _axis_coords(int(out_size_xyz[k]), float(out_spacing_xyz[k]),
                              float(in_spacing_xyz[k]))
        out = _axis_gather_np(out, axis, coords, interpolate)
    if np.issubdtype(array.dtype, np.integer) and interpolate == NEAREST:
        out = out.astype(array.dtype)
    else:
        out = out.astype(np.float32)
    return out


def resample_image(img, out_size_xyz: Sequence[int], out_spacing_xyz: Sequence[float],
                   interpolate: int = NEAREST):
    """MedicalImage wrapper keeping origin/direction (ref resample_3D parity)."""
    from dataclasses import replace
    nda = resample_nd(img.array, img.spacing, out_size_xyz, out_spacing_xyz, interpolate)
    return replace(img, array=nda, spacing=tuple(float(s) for s in out_spacing_xyz))

