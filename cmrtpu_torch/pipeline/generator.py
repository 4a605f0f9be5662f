"""Training data: the deterministic host stage and the on-device tail of the
stochastic stage — counterpart of ``cmrtpu/pipeline/generator.py``.

  1. ``DataGenerator`` runs the reference's deterministic "fix" stage once
     per file in a thread pool (load -> resample -> clip -> normalise) and
     keeps the result padded to DIM in two contiguous arrays, ``_cache_x``
     and ``_cache_y``, which the device-resident loop uploads once
     (ref: __fix_preprocessing__, src/data/Generators.py:283-344).
  2. ``finalize_batch`` is the tail of the stochastic stage on the card:
     per-example re-normalise, label -> binary channels and the Gaussian
     heatmap targets (K1) (ref: __preprocess_one_image__, :371-395).

The batches themselves are assembled on the card by
``cmrtpu_torch/train/device_cache.py``; host streaming is not ported
(ROADMAP 6.3). HEADS (3.4) and histogram matching with AUGMENT (3.1) raise.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.io import MedicalImage, read_image
from cmrtpu_torch.ops import resample as R
from cmrtpu_torch.ops.gaussian import smooth_heatmap_targets
from cmrtpu_torch.pipeline import transforms as T

_EPS = float(np.finfo(np.float32).eps)


def load_masked_img(img_path: str, mask: bool = False,
                    masking_values: Sequence[int] = (1, 2, 3),
                    replace: Tuple[str, str] = ("img", "msk"),
                    mask_labels: Sequence[int] = (0, 1, 2, 3)) -> MedicalImage:
    """Load an image, optionally zeroing everything outside given mask labels
    (ref: load_masked_img, src/data/Preprocess.py:137-179)."""
    img = read_image(img_path, dtype=np.float32)
    if mask:
        msk = read_image(img_path.replace(replace[0], replace[1]))
        channels = T.transform_to_binary_mask(msk.array, mask_labels)
        keep = np.zeros(img.array.shape, dtype=np.float32)
        for c in masking_values:
            keep += img.array * channels[..., c]
        img = img.with_array(keep)
    return img


def normalise_batch(imgs: torch.Tensor, scaler: str) -> torch.Tensor:
    """Per-example MinMax / Standard / Robust scaling of [B, ...] in float32
    (cmrtpu's ``_jax_normalise`` applied to each example)."""
    x = imgs.float()
    flat = x.reshape(x.shape[0], -1)
    scaler = scaler.lower()
    if scaler == "standard":
        mean = flat.mean(dim=1, keepdim=True)
        std = flat.std(dim=1, unbiased=False, keepdim=True)
        out = (flat - mean) / (std + _EPS)
    elif scaler == "robust":
        med = torch.quantile(flat, 0.5, dim=1, keepdim=True)
        q0 = flat.amin(dim=1, keepdim=True)
        q95 = torch.quantile(flat, 0.95, dim=1, keepdim=True)
        out = (flat - med) / (q95 - q0 + _EPS)
    else:
        lo = flat.amin(dim=1, keepdim=True)
        hi = flat.amax(dim=1, keepdim=True)
        out = (flat - lo) / (hi - lo + _EPS)
    return out.reshape(x.shape)


def finalize_batch(imgs: torch.Tensor, msks: torch.Tensor, config: Dict,
                   masks: bool = True):
    """The tail of the stochastic stage for a batch on one device: images
    [B, H, W] and label maps [B, H, W] -> (x [B, H, W, 1], y [B, H, W, C]),
    JAX's channels-last layout. ``y`` holds one binary channel per
    MASK_VALUES entry, blurred into heatmaps by K1 when GAUS is on, or the
    normalised image again when there are no masks."""
    if C.get(config, "HEADS", ()):
        raise NotImplementedError(
            "multi-head targets (HEADS) are not ported to cmrtpu_torch yet "
            "(ROADMAP 3.4)")
    scaler = C.get(config, "SCALER", "MinMax")
    x = normalise_batch(imgs, scaler)
    if masks:
        mask_values = tuple(C.get(config, "MASK_VALUES", [0, 1, 2, 3]))
        y = torch.stack([msks == v for v in mask_values], dim=-1).float()
        if C.get(config, "GAUS", False):
            y = smooth_heatmap_targets(y, float(C.get(config, "SIGMA", 1)))
    else:
        y = normalise_batch(msks, scaler)[..., None]
    return x[..., None], y


class DataGenerator:
    """The deterministic stage of cmrtpu's DataGenerator with its in-memory
    padded cache: ``_cache_x`` [N, *DIM] float32 images and ``_cache_y``
    [N, *DIM] float32 label maps (or the images again, without masks)."""

    def __init__(self, x: Sequence[str], y: Optional[Sequence[str]] = None,
                 config: Optional[Dict] = None,
                 in_memory: Optional[bool] = None):
        config = config or {}
        if y is not None:
            assert len(x) == len(y), "len(X) != len(Y)"
        if C.get(config, "HEADS", ()):
            raise NotImplementedError(
                "multi-head targets (HEADS) are not ported to cmrtpu_torch "
                "yet (ROADMAP 3.4)")
        if C.get(config, "HIST_MATCHING", False) and \
                C.get(config, "AUGMENT", False):
            raise NotImplementedError(
                "histogram matching (HIST_MATCHING with AUGMENT) is not "
                "ported to cmrtpu_torch yet (ROADMAP 3.1)")
        self.in_memory = C.get(config, "CACHE_IN_MEMORY", True) \
            if in_memory is None else in_memory
        if not self.in_memory:
            raise NotImplementedError(
                "training without the in-memory cache (host streaming) is "
                "not ported to cmrtpu_torch yet (ROADMAP 6.3)")
        self.images = list(x)
        self.labels = list(y) if y is not None else None
        self.masks = y is not None
        self.config = config

        self.scaler = C.get(config, "SCALER", "MinMax")
        self.resample = C.get(config, "RESAMPLE", False)
        self.spacing = list(C.get(config, "SPACING", [1.25, 1.25]))
        self.dim = tuple(C.get(config, "DIM", [256, 256]))
        self.img_interpolation = C.get(config, "IMG_INTERPOLATION", R.LINEAR)
        self.msk_interpolation = C.get(config, "MSK_INTERPOLATION", R.NEAREST)
        self.masking_image = C.get(config, "MASKING_IMAGE", False)
        self.masking_values = C.get(config, "MASKING_VALUES", [1, 2, 3])
        self.max_workers = min(32, C.get(config, "GENERATOR_WORKER",
                                         C.get(config, "BATCHSIZE", 32)))
        # img->msk path rule (ref: Generators.py:254-263)
        self.replace_wildcard = ((".nii.gz", "_gt.nii.gz")
                                 if x and "ACDC" in x[0] else ("img", "msk"))

        self._cache_x = self._cache_y = None
        if self.images:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                cache: List = list(pool.map(self._fix_preprocessing,
                                            range(len(self.images))))
            self._cache_x = np.stack([T.pad_and_crop(img, self.dim)
                                      for img, _ in cache])
            self._cache_y = np.stack([T.pad_and_crop(msk, self.dim)
                                      for _, msk in cache])

    def _fix_preprocessing(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """load -> resample -> clip -> normalise one example (float32)."""
        img = load_masked_img(self.images[idx], mask=self.masking_image,
                              masking_values=self.masking_values,
                              replace=self.replace_wildcard)
        msk = read_image(self.labels[idx]) if self.masks else img

        if self.resample and img.ndim in (2, 3):
            target_spacing = list(reversed(self.spacing))  # numpy -> sitk order
            new_size = T.calc_resampled_size(img.size[:len(target_spacing)],
                                             img.spacing[:len(target_spacing)],
                                             target_spacing)
            img = R.resample_image(img, new_size, target_spacing,
                                   self.img_interpolation)
            msk = R.resample_image(msk, new_size, target_spacing,
                                   self.msk_interpolation)

        img_nda = T.normalise_image(T.clip_quantile(img.array, 0.999),
                                    self.scaler)
        if self.masks:
            msk_nda = msk.array
        else:  # autoencoder mode: image twice
            msk_nda = T.normalise_image(T.clip_quantile(msk.array, 0.999),
                                        self.scaler)
        return img_nda.astype(np.float32), msk_nda.astype(np.float32)
