"""Restored model + batched forward, thresholding and the CC_FILTER cleaner —
counterpart of the serving parts of ``cmrtpu/predict/predictor.py``.

``cmrtpu.predict.predictor`` imports jax at module level, so its numpy-only
functions are re-implemented here over the port's own copies of the host
modules (``config``, ``io``, ``ops.resample``, ``pipeline.transforms``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.ops import resample as R
from cmrtpu_torch.io import MedicalImage
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.ops.connected_components import clean_prediction_2d_cc
from cmrtpu_torch.train.checkpoint import load_weights_for_model

_BUCKET = 8  # Predictor.predict pads slice batches to a multiple of this


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without CUDA raises — the CPU
    runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def cc_clean_fn(cfg: Dict):
    """The CC_FILTER knob's cleaner, or None when off. Truthy and '2d' keep
    the biggest 4-connected component per label per slice; '3d' (volume
    components) is not ported yet."""
    mode = C.get(cfg, "CC_FILTER", False)
    if isinstance(mode, str):
        norm = mode.strip().lower()
        if norm in ("", "false", "none", "0"):
            return None
        if norm == "3d":
            raise NotImplementedError(
                "CC_FILTER='3d' is not ported to cmrtpu_torch yet "
                "(ROADMAP 4.3); serve it with cmrtpu")
        if norm in ("2d", "true", "1"):
            return clean_prediction_2d_cc
        raise ValueError(
            f"CC_FILTER={mode!r}: expected a boolean, '2d' or '3d'")
    return clean_prediction_2d_cc if mode else None


class Predictor:
    """Restored model + batched forward on an explicit device."""

    def __init__(self, config: Dict, model_path: Optional[str] = None,
                 device="cuda"):
        self.config = C.normalise_config(config)
        if C.get(self.config, "TTA", False):
            raise NotImplementedError(
                "TTA is not ported to cmrtpu_torch yet (ROADMAP 5.1)")
        self.device = resolve_device(device)
        self.model = get_model(self.config)
        model_path = model_path or C.get(self.config, "MODEL_PATH")
        load_weights_for_model(model_path, self.model)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def _forward(self, x: np.ndarray) -> torch.Tensor:
        """[N, H, W, C] float32 -> [N, H, W, classes] probabilities, left on
        the device (the call returns before the device finishes)."""
        return self.model(torch.as_tensor(x, device=self.device))

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched forward, padded to a multiple of ``_BUCKET`` and trimmed
        back to the input's batch size."""
        n = x.shape[0]
        padded = -(-n // _BUCKET) * _BUCKET
        if padded != n:
            x = np.concatenate([x, np.zeros((padded - n, *x.shape[1:]), x.dtype)])
        return self._forward(x)[:n].cpu().numpy()


def threshold_and_flatten(channels: np.ndarray) -> np.ndarray:
    """sigmoid channels -> flat labels (ch0>0.5 -> 1, ch1>0.5 -> 2; later
    channels overwrite)."""
    flat = np.zeros(channels.shape[:-1], dtype=np.float64)
    for c in range(channels.shape[-1]):
        flat[channels[..., c] > 0.5] = c + 1
    return flat


def flatten_head(channels: np.ndarray, activation: str) -> np.ndarray:
    """Channel probabilities -> flat labels: sigmoid heads by the 0.5
    threshold rule, softmax heads by argmax (0 = background)."""
    if str(activation) == "softmax":
        return np.argmax(channels, axis=-1).astype(np.float64)
    return threshold_and_flatten(channels)


def _head_outputs(cfg: Dict, preds, gts: Optional[np.ndarray]):
    """[(file_suffix, pred_flat, gt_flat, label_values)] of the single
    sigmoid head, which owns the ``msk`` suffix; ``gts=None`` at serve time.
    Multi-head HEADS is not ported yet."""
    if C.get(cfg, "HEADS", ()):
        raise NotImplementedError(
            "multi-head HEADS is not ported to cmrtpu_torch yet (ROADMAP 3.4)")
    n_channels = np.asarray(preds).shape[-1] if gts is None else gts.shape[-1]
    label_values = tuple(range(1, n_channels + 1))
    return [("msk", threshold_and_flatten(preds),
             None if gts is None else threshold_and_flatten(gts),
             label_values)]


def preprocess_model_input(slices: np.ndarray, slice_spacing,
                           cfg: Dict) -> np.ndarray:
    """Deterministic inference-time preprocessing for a stack of raw 2D
    slices: per slice resample (if RESAMPLE) -> quantile clip -> normalise ->
    pad/crop to DIM -> re-normalise. ``slices`` is [N, y, x];
    ``slice_spacing`` the in-plane (x, y) spacing shared by all slices.
    Returns the model-ready [N, H, W, 1] float32 batch."""
    from cmrtpu_torch.pipeline import transforms as T

    cfg = C.normalise_config(cfg)
    dim = tuple(C.get(cfg, "DIM"))
    target_spacing = list(reversed(C.get(cfg, "SPACING")))
    scaler = C.get(cfg, "SCALER")
    resample = bool(C.get(cfg, "RESAMPLE", False))
    xs = []
    for nda in slices:
        img2d = MedicalImage(array=np.asarray(nda), spacing=slice_spacing)
        if resample:
            new_size = T.calc_resampled_size(img2d.size, img2d.spacing,
                                             target_spacing)
            img2d = R.resample_image(img2d, new_size, target_spacing,
                                     R.LINEAR)
        arr = T.normalise_image(T.clip_quantile(img2d.array, 0.999), scaler)
        arr = T.pad_and_crop(arr.astype(np.float32), dim)
        xs.append(T.normalise_image(arr, scaler))
    return np.stack(xs)[..., None]
