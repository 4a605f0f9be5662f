"""Training data: the deterministic host stage, its batches and the tail of
the stochastic stage — counterpart of ``cmrtpu/pipeline/generator.py``.

  1. ``DataGenerator`` runs the reference's deterministic "fix" stage
     (load -> resample -> clip -> normalise) per file in a thread pool. In
     memory (``CACHE_IN_MEMORY``, the default) it keeps the result padded to
     DIM in two contiguous arrays, ``_cache_x`` and ``_cache_y``, which the
     device-resident loop uploads once (ref: __fix_preprocessing__,
     src/data/Generators.py:283-344); otherwise it computes rows on demand.
  2. Its batch API is cmrtpu's: ``len`` (full batches), ``on_epoch_end``
     (the epoch order from ``np.random.default_rng(SEED)``), ``fixed_rows``,
     ``raw_batch`` (a batch of the deterministic stage packed in
     ``STREAM_DTYPE`` for the streamed loop, ``train/streaming.py``) and
     ``__getitem__`` (a finalized batch: host histogram matching, then
     augmentation from the generator's own ``torch.Generator`` and
     ``finalize_batch`` on the card).
  3. ``finalize_batch`` is the tail of the stochastic stage on the card:
     per-example re-normalise, label -> binary channels and the Gaussian
     heatmap targets (K1) (ref: __preprocess_one_image__, :371-395), or per
     HEADS entry binary channels (+ K1 heatmaps) or a one-hot.

The cached loops (``train/device_cache.py``) assemble their batches on the
card, histogram matching included. A HEADS config reads one label map per
head (the first from the y file list, the others by HEAD_MASK_RULES on the
file name) and keeps them stacked as [N, n_heads, *DIM].
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
from cmrtpu_torch.pipeline.histmatch import match_2d_on_nd
from cmrtpu_torch.utils.profiling import GLOBAL_TIMER

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
    """cmrtpu's DataGenerator: the deterministic stage, in memory as the
    padded cache ``_cache_x`` [N, *DIM] float32 images and ``_cache_y``
    [N, *DIM] float32 label maps ([N, n_heads, *DIM] with HEADS; the images
    again without masks), or on demand with ``in_memory`` False; and its
    batch API. DIM is a 2D slice's [H, W] or a cine volume's [T, H, W];
    RESAMPLE resamples a volume in plane, keeping its t axis (cmrtpu means
    to, but its call fails on the volume's geometry). ``device`` is where
    ``__getitem__`` augments and finalizes."""

    def __init__(self, x: Sequence[str], y: Optional[Sequence[str]] = None,
                 config: Optional[Dict] = None,
                 in_memory: Optional[bool] = None, device="cuda"):
        config = config or {}
        if y is not None:
            assert len(x) == len(y), "len(X) != len(Y)"
        self.in_memory = C.get(config, "CACHE_IN_MEMORY", True) \
            if in_memory is None else in_memory
        self.images = list(x)
        self.labels = list(y) if y is not None else None
        self.masks = y is not None
        self.config = config

        self.scaler = C.get(config, "SCALER", "MinMax")
        self.augment = bool(C.get(config, "AUGMENT", False))
        self.hist_matching = bool(C.get(config, "HIST_MATCHING", False))
        self.shuffle = bool(C.get(config, "SHUFFLE", True))
        self.seed = int(C.get(config, "SEED", 42))
        self.batchsize = int(C.get(config, "BATCHSIZE", 32))
        self.device = device
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

        self._rng = np.random.default_rng(self.seed)
        self._generator = None  # __getitem__'s augmentation draws
        self.indices = np.arange(len(self.images))
        self._raw_y_uint8 = None  # raw_batch's mask packing, decided once
        self._warned_u8 = False   # one-shot STREAM_DTYPE uint8 warning
        self._cache_x = self._cache_y = None
        if self.in_memory and self.images:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                fixed = list(pool.map(self._fix_preprocessing,
                                      range(len(self.images))))
            self._cache_x = np.stack([T.pad_and_crop(img, self.dim)
                                      for img, _ in fixed])
            self._cache_y = np.stack([self._pad_y(msk) for _, msk in fixed])
        self.on_epoch_end()

    def _pad_y(self, msk: np.ndarray) -> np.ndarray:
        """pad/crop a target to DIM; a head stack pads per head."""
        if self.masks and self.heads:
            return np.stack([T.pad_and_crop(m, self.dim) for m in msk])
        return T.pad_and_crop(msk, self.dim)

    def _fix_preprocessing(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """load -> resample -> clip -> normalise one example (float32),
        timed as the ``generator/fix_preprocess`` stage."""
        with GLOBAL_TIMER.stage("generator/fix_preprocess"):
            return self._fix_preprocessing_impl(idx)

    def _fix_preprocessing_impl(self, idx: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
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

    # -- the batch API (ref: BaseGenerator, Generators.py:136-173) ----------
    def __len__(self) -> int:
        """Full batches only: floor(N / BATCHSIZE)."""
        return len(self.indices) // self.batchsize

    def on_epoch_end(self) -> None:
        """The next epoch's order: a permutation from the generator's rng
        with SHUFFLE, else the file order."""
        self.indices = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(self.indices)

    def fixed_rows(self, idxs) -> Tuple[np.ndarray, np.ndarray]:
        """The padded deterministic-stage rows of the given example ids:
        the cache's rows in memory, else computed on demand in the thread
        pool (the per-host sharded upload's loader)."""
        idxs = np.asarray(idxs, dtype=int)
        if self._cache_x is not None:
            return self._cache_x[idxs], self._cache_y[idxs]
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            pairs = list(pool.map(self._fix_preprocessing, idxs.tolist()))
        return (np.stack([T.pad_and_crop(img, self.dim) for img, _ in pairs]),
                np.stack([self._pad_y(msk) for _, msk in pairs]))

    def _batch_ids(self, index: int) -> np.ndarray:
        return self.indices[index * self.batchsize:
                            (index + 1) * self.batchsize]

    def _hist_match_element(self, idx: int) -> np.ndarray:
        """Example ``idx`` matched (unpadded, on the host) against a random
        example drawn from the generator's rng, then padded (ref:
        Generators.py:350-358); a reference volume gives one slice. Both
        are decoded again: the padded cache does not hold the unpadded
        rows. Where cmrtpu reads its cache, that decode is not a
        ``generator/fix_preprocess`` stage (it counts in the batch's)."""
        fixed = self._fix_preprocessing_impl if self._cache_x is not None \
            else self._fix_preprocessing
        img_nda, _ = fixed(idx)
        ref2d, _ = fixed(int(self._rng.integers(len(self.images))))
        if ref2d.ndim == 3 and ref2d.shape[0] > 4:
            border = 2
            ref2d = ref2d[int(self._rng.integers(border,
                                                 ref2d.shape[0] - border))]
        elif ref2d.ndim == 3:
            ref2d = ref2d[ref2d.shape[0] // 2]
        return T.pad_and_crop(match_2d_on_nd(img_nda, ref2d), self.dim)

    def __getitem__(self, index: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch ``index`` finalized, as cmrtpu's ``__getitem__``: with
        HIST_MATCHING and AUGMENT each example is matched on the host with
        probability 0.1 (draws from the generator's rng); then on
        ``device`` the augmentation (draws from the generator's own
        ``torch.Generator``, seeded with SEED) and ``finalize_batch``.
        Returns (x [B, *DIM, 1], y [B, *DIM, C]) on ``device``; timed as
        the ``generator/batch`` stage."""
        with GLOBAL_TIMER.stage("generator/batch"):
            return self._getitem_impl(index)

    def _getitem_impl(self, index: int) -> Tuple[torch.Tensor, torch.Tensor]:
        idxs = self._batch_ids(index)
        hist_on = self.augment and self.hist_matching
        if self._cache_x is not None:
            imgs, msks = self._cache_x[idxs], self._cache_y[idxs]  # copies
            if hist_on:
                hits = self._rng.random(len(idxs)) < 0.1
                for pos in np.nonzero(hits)[0]:
                    imgs[pos] = self._hist_match_element(int(idxs[pos]))
        else:
            rows_x, rows_y = [], []
            for idx in idxs:
                img_nda, msk_nda = self._fix_preprocessing(int(idx))
                if hist_on and self._rng.random() < 0.1:
                    rows_x.append(self._hist_match_element(int(idx)))
                else:
                    rows_x.append(T.pad_and_crop(img_nda, self.dim))
                rows_y.append(self._pad_y(msk_nda))
            imgs, msks = np.stack(rows_x), np.stack(rows_y)
        dev = _resolve_device(self.device)
        imgs = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
        msks = torch.from_numpy(np.ascontiguousarray(msks)).to(dev)
        if self.augment:
            from cmrtpu_torch.pipeline.augment import (apply_params,
                                                       draw_params)
            if self._generator is None:
                self._generator = torch.Generator(dev).manual_seed(self.seed)
            imgs, msks = apply_params(
                draw_params(self._generator, self.config, imgs.shape[0]),
                imgs, msks)
        return finalize_batch(imgs, msks, self.config, masks=self.masks)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def raw_batch(self, index: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch ``index`` of the deterministic stage in its streamed
        storage dtypes, as host tensors (cmrtpu's ``raw_batch``): images in
        ``STREAM_DTYPE`` (bfloat16 by round to nearest even, the bits of
        ml_dtypes' cast; uint8 by per-example affine quantization; float32
        as they are), masks uint8 when they pack losslessly. The mask
        decision is made once, from the whole cache in memory or else from
        the first batch asked for, and holds: a later batch that does not
        pack raises ``ValueError``."""
        from cmrtpu_torch.train.device_cache import (_uint8_packable,
                                                     _warn_if_uint8_unsafe,
                                                     quantize_images_uint8)
        idxs = self._batch_ids(index)
        imgs, msks = self.fixed_rows(idxs)
        stream_dtype = str(C.get(self.config, "STREAM_DTYPE",
                                 "bfloat16")).lower()
        if stream_dtype in ("bfloat16", "bf16"):
            x = torch.from_numpy(imgs.astype(np.float32, copy=False)).to(
                torch.bfloat16)
        elif stream_dtype in ("uint8", "u8"):
            if not self._warned_u8:
                _warn_if_uint8_unsafe(self.config, "STREAM_DTYPE")
                self._warned_u8 = True
            x = torch.from_numpy(quantize_images_uint8(imgs))
        else:
            x = torch.from_numpy(np.ascontiguousarray(imgs))
        if self._raw_y_uint8 is None:
            self._raw_y_uint8 = _uint8_packable(
                self._cache_y if self._cache_y is not None else msks)
        if self._raw_y_uint8:
            if self._cache_y is None and not _uint8_packable(msks):
                raise ValueError(
                    f"raw_batch({index}): mask values do not pack "
                    "losslessly to uint8 but an earlier batch did: the "
                    "dataset mixes exact small-integer and float targets. "
                    "Keep targets integer-valued, or use "
                    "CACHE_IN_MEMORY=True so the packing decision sees "
                    "the whole dataset")
            msks = msks.astype(np.uint8)
        return x, torch.from_numpy(np.ascontiguousarray(msks))


def _resolve_device(device) -> torch.device:
    from cmrtpu_torch.predict.predictor import resolve_device
    return resolve_device(device)


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
