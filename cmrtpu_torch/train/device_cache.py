"""Device-resident training: the dataset lives in the card's memory, each
step gathers, augments, builds its targets and trains there — counterpart of
``cmrtpu/train/device_cache.py`` (the replicated single-device path).

    upload once -> per epoch: one [steps, B] index matrix -> per step:
        gather -> histogram matching (HIST_MATCHING with AUGMENT) -> augment
        -> normalise -> mask channels / heatmaps (K1) -> forward -> loss
        -> backward -> Adam

Epoch shuffling stays on the host with ``np.random.default_rng(SEED)``, as
in cmrtpu, so both packages visit the examples in the same order (a new
loop, a resumed one too, starts that rng again at SEED, as cmrtpu's does).
The matcher's and the augmentation's draws come from the trainer's loop
generator on the card, whose state a full-state checkpoint keeps. Only the
epoch's mean logs leave the card, in one transfer.

A 2D cache holds [N, H, W] slices, a 3D (cine) cache [N, T, H, W]
volumes: each step's draws, targets and histogram matching take one
example whole, every frame of a volume alike, as cmrtpu's do.

``CACHE_DTYPE`` sets the images' storage: float32, bfloat16 (half the
bytes) or uint8 (a quarter, per-example affine quantization); masks of
small non-negative integers are stored as uint8. Every gather casts to
float32 right after the ``index_select``, the matcher's reference rows
too. Not ported: the sharded and per-host caches and the
explicit-collectives step (ROADMAP 6.1, 6.2), which raise.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.pipeline.augment import apply_params, draw_params
from cmrtpu_torch.pipeline.generator import finalize_batch
from cmrtpu_torch.pipeline.histmatch import (draw_match, gated_match,
                                             hist_match_setup, hist_quota)


def _uint8_packable(y: np.ndarray) -> bool:
    """True when a float label cache packs losslessly to uint8 (exact small
    non-negative integers), as cmrtpu packs its mask cache."""
    if not (np.issubdtype(y.dtype, np.floating) and y.size):
        return False
    if float(y.min()) < 0 or float(y.max()) > 255:
        return False
    return bool(np.array_equal(y.astype(np.uint8).astype(y.dtype), y))


def _cache_dtype(config: Dict) -> str:
    name = str(C.get(config or {}, "CACHE_DTYPE", "float32")).lower()
    return {"f32": "float32", "bf16": "bfloat16", "u8": "uint8"}.get(name,
                                                                    name)


def quantize_images_uint8(imgs: np.ndarray) -> np.ndarray:
    """Per-example affine quantization of float images to uint8:
    round((x - min) / (max - min) * 255), chunked over examples into a
    preallocated output (cmrtpu's ``quantize_images_uint8``). Every scaler
    of ``finalize_batch`` is invariant under a per-example affine map, so
    the training math changes only by the quantization noise."""
    flat = imgs.reshape(imgs.shape[0], -1)
    out = np.empty(flat.shape, np.uint8)
    rows = max(1, (1 << 24) // max(flat.shape[1], 1))
    tiny = np.finfo(np.float32).tiny
    for start in range(0, flat.shape[0], rows):
        c = flat[start:start + rows].astype(np.float32, copy=False)
        lo = c.min(axis=1, keepdims=True)
        span = np.maximum(c.max(axis=1, keepdims=True) - lo, tiny)
        out[start:start + rows] = np.rint((c - lo) / span * 255.0)
    return out.reshape(imgs.shape)


def _warn_if_uint8_unsafe(config: Optional[Dict], knob: str) -> None:
    """The two settings under which a uint8 image cache is not transparent
    (cmrtpu's ``_warn_if_uint8_unsafe``)."""
    cfg = config or {}
    mode = C.get(cfg, "BORDER_MODE", 4)
    mode = 4 if mode is None else int(mode)  # NOT `or 4`: 0 is the case
    if mode == 0 and float(C.get(cfg, "BORDER_VALUE", 0) or 0) != 0.0:
        logging.warning(
            "%s='uint8' with a constant non-zero augmentation border "
            "(BORDER_MODE=0, BORDER_VALUE=%s): the border constant is not "
            "rescaled with the per-example quantization, so padded regions "
            "shift intensity — use BORDER_VALUE=0 or a reflect border",
            knob, C.get(cfg, "BORDER_VALUE"))
    if (bool(C.get(cfg, "HIST_MATCHING", False))
            and str(C.get(cfg, "SCALER", "MinMax")).lower() == "standard"):
        logging.warning(
            "%s='uint8' with HIST_MATCHING and SCALER='Standard': pad zeros "
            "are not the per-example minimum under Standard scaling, so "
            "quantization maps them to a mid-range bucket and the matcher's "
            "zero-exclusion stops masking the padded borders — the match "
            "histograms include border pixels (MinMax is unaffected)", knob)


def _packed_nbytes(config: Optional[Dict], x: np.ndarray,
                   y: np.ndarray) -> int:
    """The cache's bytes on the card after ``pack_arrays``."""
    x_bytes = {"bfloat16": 2 * x.size, "uint8": x.size}.get(
        _cache_dtype(config), int(x.nbytes))
    y_bytes = y.size if _uint8_packable(y) else int(y.nbytes)
    return x_bytes + y_bytes


def fits_device_cache(config: Dict, x: np.ndarray, y: np.ndarray) -> bool:
    """DEVICE_CACHE_LIMIT_GB guard on the cache's packed bytes."""
    limit_gb = float(C.get(config, "DEVICE_CACHE_LIMIT_GB", 8.0) or 8.0)
    return _packed_nbytes(config, x, y) <= limit_gb * (1 << 30)


def pack_arrays(x: np.ndarray, y: np.ndarray, config: Optional[Dict]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host cache in its storage dtypes (cmrtpu's ``_pack_arrays``):
    images float32, bfloat16 (round to nearest even, as ml_dtypes casts)
    or per-example uint8; masks uint8 when that is lossless."""
    x = np.ascontiguousarray(x)
    dtype = _cache_dtype(config)
    if dtype == "bfloat16":
        xt = torch.from_numpy(x.astype(np.float32, copy=False)).to(
            torch.bfloat16)
    elif dtype == "uint8":
        _warn_if_uint8_unsafe(config, "CACHE_DTYPE")
        xt = torch.from_numpy(quantize_images_uint8(x))
    else:  # float32, and any other name, as in cmrtpu
        xt = torch.from_numpy(x)
    y = y.astype(np.uint8) if _uint8_packable(y) else y
    return xt, torch.from_numpy(np.ascontiguousarray(y))


def upload_cache(x: np.ndarray, y: np.ndarray, device: torch.device,
                 config: Optional[Dict] = None):
    """The padded deterministic cache on ``device`` in its storage dtypes
    (cast back to float32 after each gather)."""
    xt, yt = pack_arrays(x, y, config)
    return xt.to(device), yt.to(device)


def _check_config(cfg: Dict) -> None:
    for key, what, item in (
            ("CACHE_SHARDED", "the example-sharded device cache", "6.2"),
            ("CACHE_PER_HOST", "per-host cache loading", "6.2"),
            ("GRAD_ALLREDUCE_DTYPE", "the explicit-collectives train step",
             "6.1")):
        if C.get(cfg, key, None):
            raise NotImplementedError(
                f"{what} ({key}) is not ported to cmrtpu_torch yet (ROADMAP "
                f"{item}); the port trains on one card")


class DeviceCachedLoop:
    """Drives epochs over a dataset held in the card's memory for a
    Trainer, from DataGenerators whose in-memory caches hold the arrays."""

    def __init__(self, trainer, train_gen, val_gen=None):
        cfg = trainer.config
        _check_config(cfg)
        self.trainer = trainer
        self.config = cfg
        self.device = trainer.device
        self.batch = int(C.get(cfg, "BATCHSIZE", 32) or 0)
        if self.batch <= 0:
            raise ValueError(f"BATCHSIZE must be positive, got {self.batch}")
        self.rng = np.random.default_rng(int(C.get(cfg, "SEED", 42)))
        # matcher and augmentation draws, on the card; dropout has the
        # trainer's other generator
        self.aug_generator = trainer.loop_generator
        self.shuffle = bool(C.get(cfg, "SHUFFLE", True))
        if train_gen._cache_x is None:
            raise ValueError("device-cached training needs examples: the "
                             "training set is empty")
        for gen in (train_gen, val_gen):
            if gen is not None and gen._cache_x is not None and \
                    not fits_device_cache(cfg, gen._cache_x, gen._cache_y):
                raise NotImplementedError(
                    "the dataset exceeds DEVICE_CACHE_LIMIT_GB; training "
                    "from host-streamed batches is not ported to "
                    "cmrtpu_torch yet (ROADMAP 6.3)")

        self.x_train, self.y_train = upload_cache(
            train_gen._cache_x, train_gen._cache_y, self.device, cfg)
        self.n_train = int(train_gen._cache_x.shape[0])
        self._augment = bool(C.get(cfg, "AUGMENT", False))
        self._masks = bool(train_gen.masks)
        self._match_fn, prob = hist_match_setup(cfg, self._augment)
        self._quota, self._gate_p = hist_quota(prob, self.batch) \
            if self._match_fn is not None else (0, 1.0)

        self.val = None
        if val_gen is not None and val_gen._cache_x is not None:
            self.x_val, self.y_val = upload_cache(
                val_gen._cache_x, val_gen._cache_y, self.device, cfg)
            self.n_val = int(val_gen._cache_x.shape[0])
            self._val_masks = bool(val_gen.masks)
            self.val = True
        logging.info("device cache: %d train / %s val examples resident on "
                     "%s", self.n_train, self.n_val if self.val else "no",
                     self.device)

    def _gather(self, data_x, data_y, idxs: torch.Tensor):
        return (data_x.index_select(0, idxs).float(),
                data_y.index_select(0, idxs).float())

    def hist_match(self, imgs: torch.Tensor) -> torch.Tensor:
        """Var.1: ceil(prob * B) candidates of the gathered batch, picked by
        a random permutation, each matched against a random cached row and
        kept with probability prob * B / ceil(prob * B) (``hist_quota``),
        so prob * B examples a step are matched in expectation."""
        if self._quota == 0:
            return imgs
        sel, ref_idx, gate = draw_match(self.aug_generator, imgs.shape[0],
                                        self.n_train, self._quota,
                                        self._gate_p)
        return gated_match(self._match_fn, imgs, self.x_train, sel, ref_idx,
                           gate)

    def train_step(self, idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gather -> histogram matching -> augment -> finalize (K1) -> one
        optimizer step."""
        imgs, msks = self._gather(self.x_train, self.y_train, idxs)
        if self._match_fn is not None:
            imgs = self.hist_match(imgs)
        if self._augment:
            params = draw_params(self.aug_generator, self.config,
                                 imgs.shape[0])
            imgs, msks = apply_params(params, imgs, msks)
        x, y = finalize_batch(imgs, msks, self.config, masks=self._masks)
        return self.trainer.state.train_step(x, y)

    def eval_step(self, idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        imgs, msks = self._gather(self.x_val, self.y_val, idxs)
        x, y = finalize_batch(imgs, msks, self.config, masks=self._val_masks)
        return self.trainer.state.eval_step(x, y)

    def _epoch_indices(self, n: int, shuffle: bool) -> np.ndarray:
        idxs = self.rng.permutation(n) if shuffle else np.arange(n)
        n_batches = n // self.batch
        return idxs[:n_batches * self.batch].reshape(n_batches, self.batch)

    def _to_host(self, means: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One device -> host transfer for all of an epoch's logs."""
        keys = list(means)
        values = torch.stack([means[k].float() for k in keys]).tolist()
        return dict(zip(keys, values))

    def run_train_epoch(self) -> Dict[str, float]:
        """One pass over floor(n / B) shuffled batches; the logs are the
        mean over the steps."""
        batches = self._epoch_indices(self.n_train, shuffle=self.shuffle)
        if len(batches) == 0:
            raise ValueError(
                f"device-cached epoch is empty: {self.n_train} examples < "
                f"BATCHSIZE {self.batch}")
        idx_dev = torch.from_numpy(batches).to(self.device)
        step_logs = [self.train_step(idxs) for idxs in idx_dev]
        return self._to_host({k: torch.stack([s[k] for s in step_logs]).mean()
                              for k in step_logs[0]})

    def run_eval_epoch(self) -> Dict[str, float]:
        """Every validation example: the full batches, then the remainder
        as one smaller batch (reference floor semantics would drop it); the
        epoch value is the example-weighted mean."""
        batches: List[np.ndarray] = list(
            self._epoch_indices(self.n_val, shuffle=False))
        tail = self.n_val % self.batch
        if tail:
            batches.append(np.arange(self.n_val - tail, self.n_val))
        if not batches:
            return {}
        step_logs, weights = [], []
        for idxs in batches:
            step_logs.append(self.eval_step(
                torch.from_numpy(np.asarray(idxs)).to(self.device)))
            weights.append(float(len(idxs)))
        w = torch.tensor(weights, device=self.device)
        return self._to_host({
            k: (torch.stack([s[k] for s in step_logs]).float() * w).sum()
            / w.sum() for k in step_logs[0]})
