"""Device-resident training: the dataset lives in the card's memory, each
step gathers, augments, builds its targets and trains there — counterpart of
``cmrtpu/train/device_cache.py`` on one card.

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
too.

``CACHE_SHARDED`` runs cmrtpu's sharded loop over one shard, which holds
every row (no wrap-padding): each epoch draws one permutation of the rows
from the loop's rng whatever ``SHUFFLE`` says (as cmrtpu's sharded loop
does), and ``CACHE_RESHUFFLE_EPOCHS`` k > 0 permutes both caches on the card
every k epochs with one more draw taken before the epoch's. On one shard
cmrtpu's sharded eval plan covers the same batches as the replicated eval,
so the port runs that one. ``CACHE_PER_HOST`` loads the rows through
``DataGenerator.fixed_rows`` and keeps no host cache.
``GRAD_ALLREDUCE_DTYPE`` takes the explicit-collectives step
(``train/manual_collectives.py``). cmrtpu's sharded and explicit-collectives
steps match histograms for the first rows of the batch, the replicated one
for a random permutation's; the port does as each does.

The step is a function of ``(data_x, data_y, idxs)`` (``FusedStep``), so
the streamed loop (``train/streaming.py``) runs the same step with the
current batch as its cache and ``arange(B)`` as its indices. More than one
shard or process (a ``MESH_SHAPE`` over several devices) raises: ROADMAP
6.1, 6.2.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.pipeline.augment import apply_params, draw_params
from cmrtpu_torch.pipeline.generator import finalize_batch
from cmrtpu_torch.pipeline.histmatch import (draw_match, gated_match,
                                             hist_match_setup, hist_quota)
from cmrtpu_torch.train.manual_collectives import make_manual_train_step


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


def per_host_cache(config: Optional[Dict]) -> bool:
    """True when the sharded cache loads its rows per host
    (``CACHE_PER_HOST``; its default, on for more than one process, is
    off on one). The loop, the fold's loop choice and resume all read this
    one function."""
    if not bool(C.get(config or {}, "CACHE_SHARDED", False)):
        return False
    return bool(C.get(config, "CACHE_PER_HOST", None))


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


def upload_cache_sharded_per_host(load_rows: Callable, n_examples: int,
                                  device: torch.device,
                                  config: Optional[Dict] = None):
    """``CACHE_PER_HOST``: the one process owns the one shard, so it loads
    every row through ``load_rows(ids) -> (x_rows, y_rows)``
    (``DataGenerator.fixed_rows``) and uploads them; no host cache is
    kept."""
    if n_examples <= 0:
        raise ValueError("per-host sharded upload needs at least one example")
    x_rows, y_rows = load_rows(np.arange(n_examples))
    if x_rows.shape[0] != n_examples:
        raise ValueError(f"load_rows returned {x_rows.shape[0]} rows for "
                         f"{n_examples} examples")
    return upload_cache(x_rows, y_rows, device, config)


def sharded_eval_plan(n_real: int, n_padded: int, n_shards: int,
                      local_batch: int):
    """cmrtpu's coverage plan for evaluating a wrap-padded sharded cache
    once per real example: full batches take local rows [0, steps *
    local_batch) of every shard, steps capped by the smallest per-shard
    real-row count; the real rows left over form the tail. Returns (steps,
    tail global row ids). On one shard this is the replicated eval's full
    batches and remainder, which the port runs; more shards are ROADMAP
    6.1."""
    local_n = n_padded // n_shards
    real_per_shard = [max(0, min(local_n, n_real - d * local_n))
                      for d in range(n_shards)]
    steps = min(real_per_shard) // local_batch
    covered = steps * local_batch
    tail_global = [g for d in range(n_shards)
                   for r in range(covered, local_n)
                   if (g := d * local_n + r) < n_real]
    return steps, tail_global


def _gen_examples(gen) -> int:
    """A generator's example count: its cache's rows, else its files."""
    cache = getattr(gen, "_cache_x", None)
    return int(cache.shape[0]) if cache is not None else len(gen.images)


def _fixed_rows_of(gen, ids: np.ndarray):
    """Deterministic-stage rows by id: the cache's, else the loader's."""
    cache = getattr(gen, "_cache_x", None)
    if cache is not None:
        return cache[ids], gen._cache_y[ids]
    return gen.fixed_rows(ids)


def _check_config(cfg: Dict) -> None:
    """What needs more than one device raises: the port trains on one."""
    shape = C.get(cfg, "MESH_SHAPE", None)
    if shape and int(np.prod([int(s) for s in shape])) > 1:
        raise NotImplementedError(
            f"MESH_SHAPE {list(shape)} spans more than one device; "
            "cmrtpu_torch trains on one card (more than one shard or "
            "process: ROADMAP 6.1, 6.2)")


class FusedStep:
    """The fused train and eval steps as functions of a cache
    ``(data_x, data_y)`` on the card and a batch's row ids into it: gather
    -> histogram matching (HIST_MATCHING with AUGMENT; references from
    ``data_x``) -> augment -> finalize (K1) -> one optimizer step, the
    explicit-collectives one under ``GRAD_ALLREDUCE_DTYPE``. Matcher and
    augmentation draws come from the trainer's loop generator."""

    def __init__(self, trainer, masks: bool, first_rows: bool):
        cfg = trainer.config
        _check_config(cfg)
        self.trainer = trainer
        self.config = cfg
        self.device = trainer.device
        self.batch = int(C.get(cfg, "BATCHSIZE", 32) or 0)
        if self.batch <= 0:
            raise ValueError(f"BATCHSIZE must be positive, got {self.batch}")
        self.aug_generator = trainer.loop_generator
        self._augment = bool(C.get(cfg, "AUGMENT", False))
        self._masks = bool(masks)
        self._match_fn, prob = hist_match_setup(cfg, self._augment)
        self._quota, self._gate_p = hist_quota(prob, self.batch) \
            if self._match_fn is not None else (0, 1.0)
        self._manual = bool(C.get(cfg, "GRAD_ALLREDUCE_DTYPE", None))
        # cmrtpu's sharded and explicit-collectives steps match the first
        # rows, its replicated step a random permutation's
        self._first_rows = first_rows or self._manual
        self._state_step = make_manual_train_step(trainer.state, cfg) \
            if self._manual else trainer.state.train_step

    def _gather(self, data_x, data_y, idxs: torch.Tensor):
        return (data_x.index_select(0, idxs).float(),
                data_y.index_select(0, idxs).float())

    def hist_match(self, imgs: torch.Tensor, data_x) -> torch.Tensor:
        """Var.1: ceil(prob * B) candidates of the gathered batch (random or
        first rows), each matched against a random row of ``data_x`` and
        kept with probability prob * B / ceil(prob * B) (``hist_quota``),
        so prob * B examples a step are matched in expectation."""
        if self._quota == 0:
            return imgs
        first = {"first_rows": True} if self._first_rows else {}
        sel, ref_idx, gate = draw_match(self.aug_generator, imgs.shape[0],
                                        data_x.shape[0], self._quota,
                                        self._gate_p, **first)
        return gated_match(self._match_fn, imgs, data_x, sel, ref_idx, gate)

    def train_batch(self, data_x, data_y,
                    idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One train step on rows ``idxs`` of the cache (data_x, data_y)."""
        imgs, msks = self._gather(data_x, data_y, idxs)
        if self._match_fn is not None:
            imgs = self.hist_match(imgs, data_x)
        if self._augment:
            params = draw_params(self.aug_generator, self.config,
                                 imgs.shape[0])
            imgs, msks = apply_params(params, imgs, msks)
        x, y = finalize_batch(imgs, msks, self.config, masks=self._masks)
        return self._state_step(x, y)

    def eval_batch(self, data_x, data_y, idxs: torch.Tensor,
                   masks: bool) -> Dict[str, torch.Tensor]:
        imgs, msks = self._gather(data_x, data_y, idxs)
        x, y = finalize_batch(imgs, msks, self.config, masks=masks)
        return self.trainer.state.eval_step(x, y)

    def _to_host(self, means: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One device -> host transfer for a dict of 0-d logs."""
        keys = list(means)
        values = torch.stack([means[k].float() for k in keys]).tolist()
        return dict(zip(keys, values))


class DeviceCachedLoop(FusedStep):
    """Drives epochs over a dataset held in the card's memory for a
    Trainer, from DataGenerators whose in-memory caches hold the arrays
    (or, with ``CACHE_PER_HOST``, whose ``fixed_rows`` loads them)."""

    def __init__(self, trainer, train_gen, val_gen=None):
        cfg = trainer.config
        self.sharded = bool(C.get(cfg, "CACHE_SHARDED", False))
        self.per_host = per_host_cache(cfg)
        super().__init__(trainer, getattr(train_gen, "masks", True),
                         first_rows=self.sharded)
        self.rng = np.random.default_rng(int(C.get(cfg, "SEED", 42)))
        self.shuffle = bool(C.get(cfg, "SHUFFLE", True))
        if not self.per_host and getattr(train_gen, "_cache_x", None) is None:
            raise ValueError(
                "device-cached training needs an in-memory DataGenerator "
                "with examples (CACHE_IN_MEMORY true), or CACHE_SHARDED with "
                "CACHE_PER_HOST")
        self.n_train = _gen_examples(train_gen)
        self.x_train, self.y_train = self._upload(train_gen, self.n_train)
        self._reshuffle_epochs = int(
            C.get(cfg, "CACHE_RESHUFFLE_EPOCHS", 0) or 0) \
            if self.sharded else 0
        self._epochs_run = 0

        self.val = None
        if val_gen is not None and (self.per_host or getattr(
                val_gen, "_cache_x", None) is not None):
            self.n_val = _gen_examples(val_gen)
            self._val_masks = bool(getattr(val_gen, "masks", True))
            self.x_val, self.y_val = self._upload(val_gen, self.n_val)
            self.val = True
        logging.info("device cache: %d train / %s val examples resident on "
                     "%s (%s)", self.n_train,
                     self.n_val if self.val else "no", self.device,
                     ("sharded over 1 shard" + (", per-host row loading"
                                                if self.per_host else ""))
                     if self.sharded else "replicated")

    def _upload(self, gen, n: int):
        """A generator's cache on the card: its rows loaded per host
        (``CACHE_PER_HOST``), else its in-memory cache."""
        if self.per_host:
            return upload_cache_sharded_per_host(
                lambda ids: _fixed_rows_of(gen, ids), n, self.device,
                self.config)
        return upload_cache(gen._cache_x, gen._cache_y, self.device,
                            self.config)

    def train_step(self, idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gather -> histogram matching -> augment -> finalize (K1) -> one
        optimizer step, on rows ``idxs`` of the training cache."""
        return self.train_batch(self.x_train, self.y_train, idxs)

    def eval_step(self, idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.eval_batch(self.x_val, self.y_val, idxs, self._val_masks)

    def _epoch_indices(self, n: int, shuffle: bool) -> np.ndarray:
        idxs = self.rng.permutation(n) if shuffle else np.arange(n)
        n_batches = n // self.batch
        return idxs[:n_batches * self.batch].reshape(n_batches, self.batch)

    def _maybe_reshuffle(self) -> None:
        """CACHE_RESHUFFLE_EPOCHS k > 0 (sharded cache only): before every
        k-th epoch after the first, one more permutation from the loop's rng
        (drawn before the epoch's indices) reorders both caches on the card;
        the old caches are freed before the epoch runs."""
        if (not self._reshuffle_epochs or self._epochs_run == 0
                or self._epochs_run % self._reshuffle_epochs):
            return
        perm = torch.from_numpy(
            self.rng.permutation(self.n_train)).to(self.device)
        self.x_train = self.x_train.index_select(0, perm)
        self.y_train = self.y_train.index_select(0, perm)

    def run_train_epoch(self) -> Dict[str, float]:
        """One pass over floor(n / B) batches (shuffled per SHUFFLE, or
        always on the sharded cache); the logs are the mean over the
        steps."""
        self._maybe_reshuffle()
        self._epochs_run += 1
        batches = self._epoch_indices(self.n_train,
                                      shuffle=self.shuffle or self.sharded)
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
