"""Deterministic preprocessing transforms with exact reference parity.

Host (numpy) implementations of the reference's preprocessing primitives
(ref: src/data/Preprocess.py): the centre pad-and-crop with its floor/floor+1
complement rule, quantile clipping, intensity scalers, label<->channel
transforms and the resampled-size rounding. The port's own copy of
``cmrtpu/pipeline/transforms.py``.
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np

EPS = sys.float_info.epsilon


def calc_resampled_size(size_xyz: Sequence[int], spacing_xyz: Sequence[float],
                        target_spacing_xyz: Sequence[float]) -> List[int]:
    """New per-axis size after resampling to ``target_spacing``.

    np.around rounding, x,y,z (sitk) axis order — exact parity with
    ref: src/data/Preprocess.py:123-134.
    """
    old_size = np.asarray(size_xyz, dtype=np.float64)
    old_spacing = np.asarray(spacing_xyz, dtype=np.float64)
    target = np.asarray(target_spacing_xyz, dtype=np.float64)
    new_size = (old_size * old_spacing) / target
    return [int(v) for v in np.around(new_size).astype(np.int64)]


def pad_crop_margins(shape: Sequence[int], target_shape: Sequence[int]
                     ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Per-axis (pad, crop) margins of the centre pad-and-crop.

    The reference's complement rule (ref: src/data/Preprocess.py:494-541):
    for an odd difference the *first* margin takes the extra voxel both when
    padding and when cropping, i.e. left = ceil(|d|/2), right = floor(|d|/2).
    """
    pads, crops = [], []
    for s, t in zip(shape, target_shape):
        d = int(s) - int(t)
        if d < 0:
            n = -d
            pads.append((n - n // 2, n // 2))
            crops.append((0, 0))
        else:
            pads.append((0, 0))
            crops.append((d - d // 2, d // 2))
    return pads, crops


def pad_and_crop(ndarray: np.ndarray, target_shape: Sequence[int],
                 constant: float = 0.0) -> np.ndarray:
    """Centre pad/crop to ``target_shape`` (ref: src/data/Preprocess.py:494-541).

    Unlike the reference (which always returns float64 via np.zeros), the
    input dtype is preserved; every consumer in the reference immediately
    renormalised or cast, so this is value-identical.
    """
    target_shape = tuple(int(t) for t in target_shape)
    assert ndarray.ndim == len(target_shape), (
        f"rank mismatch: {ndarray.shape} vs {target_shape}")
    pads, crops = pad_crop_margins(ndarray.shape, target_shape)
    out = np.full(target_shape, constant, dtype=ndarray.dtype)
    out_slices = tuple(slice(p0, t - p1) for (p0, p1), t in zip(pads, target_shape))
    in_slices = tuple(slice(c0, s - c1) for (c0, c1), s in zip(crops, ndarray.shape))
    out[out_slices] = ndarray[in_slices]
    return out


def clip_quantile(img_nda: np.ndarray, upper_quantile: float = 0.999,
                  lower_boundary: float = 0.0) -> np.ndarray:
    """Clip to [lower, q(upper)] (ref: src/data/Preprocess.py:458-468)."""
    q = np.quantile(img_nda.reshape(-1), upper_quantile)
    return np.clip(img_nda, lower_boundary, q)


def normalise_image(img_nda: np.ndarray, normaliser: str = "minmax") -> np.ndarray:
    """MinMax / Standard / Robust scaling (ref: src/data/Preprocess.py:471-491).

    Robust deviates deliberately from the reference's per-column
    sklearn.RobustScaler quirk (which only worked on 2D inputs): here it is a
    global median / (q95 - q0) scaling over the whole array.
    """
    normaliser = normaliser.lower()
    img_nda = np.asarray(img_nda, dtype=np.float32)
    if normaliser == "standard":
        return (img_nda - np.mean(img_nda)) / (np.std(img_nda) + EPS)
    if normaliser == "robust":
        med = np.median(img_nda)
        q0, q95 = np.quantile(img_nda, [0.0, 0.95])
        return (img_nda - med) / (q95 - q0 + EPS)
    return (img_nda - img_nda.min()) / (img_nda.max() - img_nda.min() + EPS)


def transform_to_binary_mask(mask_nda: np.ndarray,
                             mask_values: Sequence[int] = (0, 1, 2, 3)) -> np.ndarray:
    """Value-based labels -> per-value binary channels (ref: Preprocess.py:425-437)."""
    mask = np.zeros((*mask_nda.shape, len(mask_values)), dtype=bool)
    for ix, value in enumerate(mask_values):
        mask[..., ix] = mask_nda == value
    return mask


def from_channel_to_flat(binary_mask: np.ndarray, start_c: int = 0) -> np.ndarray:
    """Channel-wise mask (thresholded at 0.5) -> value-based labels.

    Later channels win on overlap, matching ref: src/data/Preprocess.py:440-455.
    """
    binary_mask = np.asarray(binary_mask) >= 0.5
    out = np.zeros(binary_mask.shape[:-1], dtype=np.uint8)
    for c in range(binary_mask.shape[-1]):
        out[binary_mask[..., c]] = c + start_c
    return out


def threshold_to_flat_labels(pred: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Sigmoid channels -> flat {1: anterior, 2: inferior, ...} labels.

    Mirrors the prediction flattening at ref: src/models/predict_model.py:149-156
    (channel 0 -> value 1, channel 1 -> value 2; later channels overwrite).
    """
    out = np.zeros(pred.shape[:-1], dtype=np.uint8)
    for c in range(pred.shape[-1]):
        out[pred[..., c] > threshold] = c + 1
    return out
