"""Training data: the deterministic host stage and the on-device tail of the
stochastic stage — counterpart of ``cmrtpu/pipeline/generator.py``.

  1. ``DataGenerator`` runs the reference's deterministic "fix" stage once
     per file in a thread pool (load -> resample -> clip -> normalise) and
     keeps the result padded to DIM in two contiguous arrays, ``_cache_x``
     and ``_cache_y``, which the device-resident loop uploads once
     (ref: __fix_preprocessing__, src/data/Generators.py:283-344).
  2. ``finalize_batch`` is the tail of the stochastic stage on the card:
     per-example re-normalise, label -> binary channels and the Gaussian
     heatmap targets (K1) (ref: __preprocess_one_image__, :371-395), or per
     HEADS entry binary channels (+ K1 heatmaps) or a one-hot.

The batches themselves are assembled on the card by
``cmrtpu_torch/train/device_cache.py``, which also does the histogram
matching of HIST_MATCHING with AUGMENT; host streaming is not ported
(ROADMAP 6.3). A HEADS config reads one label map per head (the first from
the y file list, the others by HEAD_MASK_RULES on the file name) and caches
them stacked as [N, n_heads, *DIM].
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.data.dataset import create_2d_slices_from_4d_volume_file
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
    [B, *DIM] and label maps [B, *DIM] (DIM is [H, W] or a cine volume's
    [T, H, W]) -> (x [B, *DIM, 1], y [B, *DIM, C]), JAX's channels-last
    layout. ``y`` holds one binary channel per MASK_VALUES entry, blurred
    into heatmaps by K1 when GAUS is on (every [H, W] plane of the batch in
    one launch), or the normalised image again when there are no masks.

    With HEADS the label maps are [B, n_heads, *DIM], one per head, and
    ``y`` concatenates per head in HEADS order: a one-hot of labels
    0..C-1 for a softmax head, binary channels for labels 1..C for a
    sigmoid head (K1 heatmaps when GAUS is on, one launch per such head)."""
    scaler = C.get(config, "SCALER", "MinMax")
    heads = tuple(tuple(h) for h in C.get(config, "HEADS", ()) or ())
    x = normalise_batch(imgs, scaler)
    if masks and heads:
        parts = []
        for i, (_, channels, act) in enumerate(heads):
            m = msks[:, i]
            if str(act) == "softmax":
                part = torch.stack([m == v for v in range(int(channels))],
                                   dim=-1).float()
            else:
                part = torch.stack([m == v for v in
                                    range(1, int(channels) + 1)],
                                   dim=-1).float()
                if C.get(config, "GAUS", False):
                    part = smooth_heatmap_targets(
                        part, float(C.get(config, "SIGMA", 1)))
            parts.append(part)
        y = torch.cat(parts, dim=-1)
    elif masks:
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
    [N, *DIM] float32 label maps ([N, n_heads, *DIM] with HEADS; the images
    again without masks). DIM is a 2D slice's [H, W] or a cine volume's
    [T, H, W]; RESAMPLE resamples a volume in plane, keeping its t axis
    (cmrtpu means to, but its call fails on the volume's geometry)."""

    def __init__(self, x: Sequence[str], y: Optional[Sequence[str]] = None,
                 config: Optional[Dict] = None,
                 in_memory: Optional[bool] = None):
        config = config or {}
        if y is not None:
            assert len(x) == len(y), "len(X) != len(Y)"
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
        # multi-head sources: head 0 reads the y file itself, each further
        # head the y path rewritten by a [find, replace] rule on the file
        # name (default 'msk' -> the head's name)
        self.heads = tuple(tuple(h) for h in C.get(config, "HEADS", ()) or ())
        if self.heads:
            rules = C.get(config, "HEAD_MASK_RULES", None)
            self.head_mask_rules = [tuple(r) for r in rules] if rules else \
                [None] + [("msk", str(name)) for name, _, _ in self.heads[1:]]
            assert len(self.head_mask_rules) == len(self.heads), (
                "HEAD_MASK_RULES must have one [find, replace] entry per head")

        self._cache_x = self._cache_y = None
        if self.images:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                cache: List = list(pool.map(self._fix_preprocessing,
                                            range(len(self.images))))
            self._cache_x = np.stack([T.pad_and_crop(img, self.dim)
                                      for img, _ in cache])
            self._cache_y = np.stack([self._pad_y(msk) for _, msk in cache])

    def _pad_y(self, msk: np.ndarray) -> np.ndarray:
        """pad/crop a target to DIM; a head stack pads per head."""
        if self.masks and self.heads:
            return np.stack([T.pad_and_crop(m, self.dim) for m in msk])
        return T.pad_and_crop(msk, self.dim)

    def _fix_preprocessing(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """load -> resample -> clip -> normalise one example (float32)."""
        img = load_masked_img(self.images[idx], mask=self.masking_image,
                              masking_values=self.masking_values,
                              replace=self.replace_wildcard)
        if self.masks and self.heads:
            msks = []
            for rule in self.head_mask_rules:
                # the rule rewrites the file name only, never a directory
                head, base = os.path.split(self.labels[idx])
                path = self.labels[idx] if rule is None \
                    else os.path.join(head, base.replace(rule[0], rule[1]))
                msks.append(read_image(path))
        else:
            msks = [read_image(self.labels[idx]) if self.masks else img]

        if self.resample and img.ndim in (2, 3):
            target_spacing = list(reversed(self.spacing))  # numpy -> sitk order
            k = len(target_spacing)
            new_size = T.calc_resampled_size(img.size[:k], img.spacing[:k],
                                             target_spacing)
            # a volume is resampled in plane: its other axes keep their size
            # and spacing (cmrtpu drops their spacing, and its image then
            # fails its own geometry check)
            new_size = [*new_size, *img.size[k:]]
            target_spacing = [*target_spacing, *img.spacing[k:]]
            img = R.resample_image(img, new_size, target_spacing,
                                   self.img_interpolation)
            msks = [R.resample_image(m, new_size, target_spacing,
                                     self.msk_interpolation) for m in msks]

        img_nda = T.normalise_image(T.clip_quantile(img.array, 0.999),
                                    self.scaler)
        if not self.masks:  # autoencoder mode: image twice
            msk_nda = T.normalise_image(T.clip_quantile(msks[0].array, 0.999),
                                        self.scaler)
        elif self.heads:
            msk_nda = np.stack([m.array for m in msks])  # [n_heads, *spatial]
        else:
            msk_nda = msks[0].array
        return img_nda.astype(np.float32), msk_nda.astype(np.float32)


def sliceable(generator_cls, x: Sequence[str], y=None,
              config: Optional[Dict] = None,
              temp_path: str = "data/interim") -> List[DataGenerator]:
    """One 2D generator (BATCHSIZE 1) per 4D file of ``x``, over the t x z
    slices that ``create_2d_slices_from_4d_volume_file`` writes under
    ``temp_path``, for running a 2D model over cine stacks (ref: sliceable,
    src/data/Generators.py:401-424)."""
    cfg = dict(config or {})
    cfg["BATCHSIZE"] = 1
    generators = []
    for img_f in x:
        sliced = create_2d_slices_from_4d_volume_file(img_f, temp_path)
        logging.info("x_sliced: %d, example: %s", len(sliced), sliced[0])
        generators.append(generator_cls(x=sliced, y=None, config=cfg))
    return generators
