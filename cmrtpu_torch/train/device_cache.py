"""Device-resident training: the dataset lives in the card's memory, each
step gathers, augments, builds its targets and trains there — counterpart of
``cmrtpu/train/device_cache.py``.

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

Over W ranks (``trainer.mesh``, ``parallel/mesh.py``) every rank runs the
same loop with the same host rng, so all draw the same index matrix:
  * replicated cache (the default): every rank holds every row and takes
    its block of each step's global index row;
  * ``CACHE_SHARDED``: the rows, wrap-padded to a multiple of W, are split
    in W contiguous blocks, one a rank; the index matrix holds local row
    ids, a column block per shard drawn from its own permutation, so the
    gather needs no communication; the eval covers each real row once
    (``sharded_eval_plan``), the rows left over as one tail batch that every
    rank evaluates whole; ``CACHE_RESHUFFLE_EPOCHS`` k > 0 moves the rows
    to a new global permutation every k epochs (``all_to_all``);
    ``CACHE_PER_HOST`` (on by default over more than one process) loads
    only the rank's block through ``DataGenerator.fixed_rows``.
The augmentation is drawn for the global batch from generators in the same
state on every rank, and each rank applies its rows' draws, so W ranks
take the same step as one rank would on the same global batch. The matcher
is drawn for the global batch too (replicated global-view step), or once a
shard for the first rows of each shard's batch (the sharded and
explicit-collectives steps, as cmrtpu's). ``GRAD_ALLREDUCE_DTYPE`` takes
the explicit-collectives step (``train/manual_collectives.py``).

The step is a function of ``(data_x, data_y, idxs)`` (``FusedStep``), so
the streamed loop (``train/streaming.py``) runs the same step with the
rank's rows of the current batch as its cache.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.parallel import mesh as M
from cmrtpu_torch.pipeline.augment import apply_params, draw_params
from cmrtpu_torch.pipeline.generator import finalize_batch
from cmrtpu_torch.pipeline.histmatch import (draw_match, gated_match,
                                             hist_match_setup, hist_quota)
from cmrtpu_torch.train.manual_collectives import make_manual_train_step
from cmrtpu_torch.utils.profiling import span


def cache_nbytes(*arrays) -> int:
    """The unpacked bytes of the arrays (numpy or tensors), as cmrtpu
    counts a cache; ``_packed_nbytes`` counts what the card holds."""
    return sum(int(a.nbytes) for a in arrays)


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




def fits_device_cache(config: Dict, x: np.ndarray, y: np.ndarray,
                      n_shards: int = 1) -> bool:
    """DEVICE_CACHE_LIMIT_GB guard on the cache's packed bytes; the limit
    is per device, so a cache sharded over ``n_shards`` may be that many
    times larger."""
    limit_gb = float(C.get(config, "DEVICE_CACHE_LIMIT_GB", 8.0) or 8.0)
    return _packed_nbytes(config, x, y) <= \
        limit_gb * (1 << 30) * max(1, int(n_shards))


def cache_shards(config: Optional[Dict], mesh: M.Mesh) -> int:
    """The shards the cache spreads its rows over: the data axis's size
    under CACHE_SHARDED, else 1 (replicated)."""
    if not bool(C.get(config or {}, "CACHE_SHARDED", False)):
        return 1
    return int(mesh.data)


def per_host_cache(config: Optional[Dict]) -> bool:
    """True when the sharded cache loads its rows per host
    (``CACHE_PER_HOST``; on by default over more than one process). The
    loop, the fold's loop choice and resume all read this one function."""
    if not bool(C.get(config or {}, "CACHE_SHARDED", False)):
        return False
    knob = C.get(config, "CACHE_PER_HOST", None)
    return M.multi_process() if knob is None else bool(knob)


def pack_arrays(x: np.ndarray, y: np.ndarray, config: Optional[Dict],
                y_uint8: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host cache in its storage dtypes (cmrtpu's ``_pack_arrays``):
    images float32, bfloat16 (round to nearest even, as ml_dtypes casts)
    or per-example uint8; masks uint8 when that is lossless, or as
    ``y_uint8`` decides (a decision taken for every shard at once)."""
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
    if _uint8_packable(y) if y_uint8 is None else y_uint8:
        y = y.astype(np.uint8)
    return xt, torch.from_numpy(np.ascontiguousarray(y))


def upload_cache(x: np.ndarray, y: np.ndarray, device: torch.device,
                 config: Optional[Dict] = None):
    """The padded deterministic cache on ``device`` in its storage dtypes
    (cast back to float32 after each gather)."""
    xt, yt = pack_arrays(x, y, config)
    return xt.to(device), yt.to(device)


def upload_cache_sharded_per_host(load_rows: Callable, n_examples: int,
                                  mesh: M.Mesh, device: torch.device,
                                  config: Optional[Dict] = None):
    """The rank's block of the example-sharded cache: the rows wrap-padded
    to a multiple of the shards (``n_padded``; the duplicates are rows a
    remainder-dropping epoch would under-sample), block d holding global
    rows [d * local_n, (d + 1) * local_n). A process drives one device, so
    it owns one block, ``mesh.block`` (model-axis replicas share it: cmrtpu's
    ``_owned_data_blocks``), and only that block's ids go to
    ``load_rows(ids) -> (x_rows, y_rows)`` (``DataGenerator.fixed_rows``);
    the mask-packing decision is one for every shard (``all_agree``).
    Returns (data_x, data_y, n_padded)."""
    if n_examples <= 0:
        raise ValueError("per-host sharded upload needs at least one example")
    n_shards = int(mesh.data)
    padded = -(-n_examples // n_shards) * n_shards
    local_n = padded // n_shards
    ids = np.arange(mesh.block * local_n,
                    (mesh.block + 1) * local_n) % n_examples
    x_rows, y_rows = load_rows(ids)
    if x_rows.shape[0] != local_n:
        raise ValueError(f"load_rows returned {x_rows.shape[0]} rows for a "
                         f"{local_n}-row block")
    y_u8 = M.all_agree(_uint8_packable(np.asarray(y_rows)), mesh)
    xt, yt = pack_arrays(x_rows, np.asarray(y_rows), config, y_uint8=y_u8)
    return xt.to(device), yt.to(device), padded


def upload_cache_sharded(x: np.ndarray, y: np.ndarray, mesh: M.Mesh,
                         device: torch.device,
                         config: Optional[Dict] = None):
    """``upload_cache_sharded_per_host`` from whole host arrays (every rank
    holds them; each packs and uploads only its block). Returns (data_x,
    data_y, n_padded)."""
    def rows(ids):
        if ids[-1] - ids[0] + 1 == len(ids):  # no wrap: a view, no copy
            ids = slice(int(ids[0]), int(ids[-1]) + 1)
        return x[ids], y[ids]

    return upload_cache_sharded_per_host(rows, int(x.shape[0]), mesh,
                                         device, config)


def sharded_eval_plan(n_real: int, n_padded: int, n_shards: int,
                      local_batch: int):
    """cmrtpu's coverage plan for evaluating a wrap-padded sharded cache
    once per real example: full batches take local rows [0, steps *
    local_batch) of every shard, steps capped by the smallest per-shard
    real-row count; the real rows left over form the tail. Returns (steps,
    tail global row ids). On one shard this is the replicated eval's full
    batches and remainder."""
    local_n = n_padded // n_shards
    real_per_shard = [max(0, min(local_n, n_real - d * local_n))
                      for d in range(n_shards)]
    steps = min(real_per_shard) // local_batch
    covered = steps * local_batch
    tail_global = [g for d in range(n_shards)
                   for r in range(covered, local_n)
                   if (g := d * local_n + r) < n_real]
    return steps, tail_global


def reshuffle_shards(x: torch.Tensor, y: torch.Tensor, perm: np.ndarray,
                     mesh: M.Mesh):
    """The sharded caches after a global permutation: new global row g is
    old global row ``perm[g]``. On one shard an ``index_select``; over W
    shards each rank sends every other rank the rows of its block that
    land in theirs, in one ``all_to_all`` an array (the rows as bytes).
    Peak memory: about four blocks of the array moved (the old block, the
    send and receive buffers and the new block), x then y."""
    if mesh.data == 1:
        p = torch.from_numpy(perm).to(x.device)
        return x.index_select(0, p), y.index_select(0, p)
    local_n, me = x.shape[0], mesh.block
    blocks = perm.reshape(mesh.data, local_n)
    sends = [b[b // local_n == me] % local_n for b in blocks]
    src = blocks[me] // local_n
    recv_counts = np.bincount(src, minlength=mesh.data)
    # received rows come by source rank, each source's in position order
    order = torch.from_numpy(np.argsort(src, kind="stable")).to(x.device)
    idx = torch.from_numpy(np.concatenate(sends)).to(x.device)
    out = []
    for t in (x, y):
        recv = M.all_to_all_rows(t.index_select(0, idx),
                                 [len(s) for s in sends], recv_counts, mesh)
        new = torch.empty_like(t)
        new[order] = recv
        out.append(new)
    return tuple(out)


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


class FusedStep:
    """The fused train and eval steps as functions of a cache
    ``(data_x, data_y)`` on the card and a global batch's row ids into it:
    gather -> histogram matching (HIST_MATCHING with AUGMENT; references
    from ``data_x``) -> augment -> finalize (K1) -> one optimizer step, the
    explicit-collectives one under ``GRAD_ALLREDUCE_DTYPE``. Matcher and
    augmentation draws come from the trainer's loop generator.

    Over W ranks each runs the rank's block of the batch (``local_batch``
    rows). With ``first_rows`` (the sharded cache, the streamed batch, the
    explicit-collectives step) the rank gathers only its rows and the
    matcher is drawn once a shard; otherwise the rank gathers the global
    batch, matches it and keeps its rows. The augmentation is drawn for the
    global batch either way."""

    def __init__(self, trainer, masks: bool, first_rows: bool):
        cfg = trainer.config
        self.trainer = trainer
        self.config = cfg
        self.device = trainer.device
        self.mesh = trainer.mesh
        self.batch = int(C.get(cfg, "BATCHSIZE", 32) or 0)
        if self.batch <= 0:
            raise ValueError(f"BATCHSIZE must be positive, got {self.batch}")
        self.local_batch = M.local_batch_size(self.batch, self.mesh)
        self._rows = M.local_rows(self.batch, self.mesh)
        self.aug_generator = trainer.loop_generator
        self._augment = bool(C.get(cfg, "AUGMENT", False))
        self._masks = bool(masks)
        self._manual = bool(C.get(cfg, "GRAD_ALLREDUCE_DTYPE", None))
        # cmrtpu's sharded and explicit-collectives steps match the first
        # rows of each shard, its replicated step a random permutation's
        self._first_rows = first_rows or self._manual
        self._match_fn, prob = hist_match_setup(cfg, self._augment)
        self._quota, self._gate_p = hist_quota(
            prob, self.local_batch if self._first_rows else self.batch) \
            if self._match_fn is not None else (0, 1.0)
        self._state_step = make_manual_train_step(trainer.state, cfg) \
            if self._manual else trainer.state.train_step

    def _gather(self, data_x, data_y, idxs: torch.Tensor):
        return (data_x.index_select(0, idxs).float(),
                data_y.index_select(0, idxs).float())

    def hist_match(self, imgs: torch.Tensor, data_x) -> torch.Tensor:
        """Var.1: ceil(prob * B) candidates of the gathered batch (random or
        first rows), each matched against a random row of ``data_x`` and
        kept with probability prob * B / ceil(prob * B) (``hist_quota``),
        so prob * B examples a step are matched in expectation. First
        rows: one draw a shard, the rank keeps its own."""
        if self._quota == 0:
            return imgs
        shards = self.mesh.data if self._first_rows else 1
        first = {"first_rows": True} if self._first_rows else {}
        for shard in range(shards):
            drawn = draw_match(self.aug_generator, imgs.shape[0],
                               data_x.shape[0], self._quota, self._gate_p,
                               **first)
            if shard == self.mesh.block or shards == 1:
                mine = drawn
        return gated_match(self._match_fn, imgs, data_x, *mine)

    def _local_params(self, params: Dict) -> Dict:
        if self.mesh.data == 1:
            return params
        return {k: v[self._rows] if torch.is_tensor(v) else v
                for k, v in params.items()}

    def train_batch(self, data_x, data_y,
                    idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One train step on the rank's rows of the global batch whose ids
        into the cache (data_x, data_y) are ``idxs`` [B]: the span
        ``train.step`` (the state's step count in its args) over
        ``train.gather``, ``train.hist_match`` (when on),
        ``train.augment``, ``train.finalize`` and the state's step."""
        with span("train.step", step=self.trainer.state.step):
            with span("train.gather"):
                if self._first_rows:
                    idxs = idxs[self._rows]
                imgs, msks = self._gather(data_x, data_y, idxs)
            if self._match_fn is not None:
                with span("train.hist_match"):
                    imgs = self.hist_match(imgs, data_x)
            with span("train.augment"):
                params = draw_params(self.aug_generator, self.config,
                                     self.batch) if self._augment else None
                if not self._first_rows and self.mesh.data > 1:
                    imgs, msks = imgs[self._rows], msks[self._rows]
                if params is not None:
                    imgs, msks = apply_params(self._local_params(params),
                                              imgs, msks)
            with span("train.finalize"):
                x, y = finalize_batch(imgs, msks, self.config,
                                      masks=self._masks)
            return self._state_step(x, y)

    def eval_batch(self, data_x, data_y, idxs: torch.Tensor, masks: bool,
                   whole: bool = False) -> Dict[str, torch.Tensor]:
        """The eval logs of the global batch ``idxs``: the rank's rows,
        gathered after the forward; with ``whole`` every rank evaluates all
        of ``idxs`` itself, with no collective (the eval's tail)."""
        if not whole:
            idxs = idxs[self._rows]
        imgs, msks = self._gather(data_x, data_y, idxs)
        x, y = finalize_batch(imgs, msks, self.config, masks=masks)
        return self.trainer.state.eval_step(x, y, gather=not whole)

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
        self.n_shards = cache_shards(cfg, trainer.mesh)
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
        self.x_train, self.y_train, self._n_train_padded = self._upload(
            train_gen, self.n_train)
        self._local_n_train = self._n_train_padded // self.n_shards
        self._reshuffle_epochs = int(
            C.get(cfg, "CACHE_RESHUFFLE_EPOCHS", 0) or 0) \
            if self.sharded else 0
        self._epochs_run = 0

        self.val = None
        if val_gen is not None and (self.per_host or getattr(
                val_gen, "_cache_x", None) is not None):
            self.n_val = _gen_examples(val_gen)
            self._val_masks = bool(getattr(val_gen, "masks", True))
            self.x_val, self.y_val, n_val_padded = self._upload(
                val_gen, self.n_val)
            self._plan_eval(val_gen, n_val_padded)
            self.val = True
        logging.info("device cache: %d train / %s val examples resident on "
                     "%s (%s)", self.n_train,
                     self.n_val if self.val else "no", self.device,
                     (f"sharded over {self.n_shards} shard(s)"
                      + (", per-host row loading" if self.per_host else ""))
                     if self.sharded else "replicated")

    def _upload(self, gen, n: int):
        """A generator's cache on the card, with its padded row count: the
        rank's block of the sharded cache (its rows loaded per host with
        ``CACHE_PER_HOST``), else every row."""
        if self.per_host:
            return upload_cache_sharded_per_host(
                lambda ids: _fixed_rows_of(gen, ids), n, self.mesh,
                self.device, self.config)
        if self.sharded:
            return upload_cache_sharded(gen._cache_x, gen._cache_y,
                                        self.mesh, self.device, self.config)
        return (*upload_cache(gen._cache_x, gen._cache_y, self.device,
                              self.config), n)

    def _plan_eval(self, val_gen, n_val_padded: int) -> None:
        """Full eval batches, and the rows left over as one tail batch
        that every rank evaluates whole: the replicated cache's remainder,
        or the real rows the sharded plan leaves (loaded and uploaded once,
        every rank alike, when the cache has more than one shard)."""
        if self.sharded:
            steps, tail = sharded_eval_plan(self.n_val, n_val_padded,
                                            self.n_shards, self.local_batch)
        else:
            steps = self.n_val // self.batch
            tail = list(range(steps * self.batch, self.n_val))
        self._val_steps = steps
        self._val_tail = None
        if not tail:
            return
        if self.n_shards == 1:  # global ids are the cache's own rows
            x, y, ids = self.x_val, self.y_val, np.asarray(tail)
        else:
            x, y = upload_cache(*_fixed_rows_of(val_gen, np.asarray(tail)),
                                self.device, self.config)
            ids = np.arange(len(tail))
        self._val_tail = (x, y, torch.from_numpy(ids).to(self.device))

    def train_step(self, idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gather -> histogram matching -> augment -> finalize (K1) -> one
        optimizer step, on the rank's rows of the global index row
        ``idxs`` into the training cache."""
        return self.train_batch(self.x_train, self.y_train, idxs)

    def eval_step(self, idxs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.eval_batch(self.x_val, self.y_val, idxs, self._val_masks)

    def _epoch_indices(self, n: int, shuffle: bool) -> np.ndarray:
        idxs = self.rng.permutation(n) if shuffle else np.arange(n)
        n_batches = n // self.batch
        return idxs[:n_batches * self.batch].reshape(n_batches, self.batch)

    def _epoch_indices_sharded(self) -> np.ndarray:
        """[steps, B] local row ids: each shard's column block an epoch
        permutation of its local rows, so every row is visited once an
        epoch and each batch holds B / shards rows of each shard."""
        steps = self._local_n_train // self.local_batch
        cols = [self.rng.permutation(self._local_n_train)
                [:steps * self.local_batch].reshape(steps, self.local_batch)
                for _ in range(self.n_shards)]
        return np.concatenate(cols, axis=1)

    def _maybe_reshuffle(self) -> None:
        """CACHE_RESHUFFLE_EPOCHS k > 0 (sharded cache only): before every
        k-th epoch after the first, one more permutation of the padded rows
        from the loop's rng (drawn before the epoch's indices) moves both
        caches (``reshuffle_shards``); the old caches are freed before the
        epoch runs."""
        if (not self._reshuffle_epochs or self._epochs_run == 0
                or self._epochs_run % self._reshuffle_epochs):
            return
        perm = self.rng.permutation(self._n_train_padded)
        self.x_train, self.y_train = reshuffle_shards(
            self.x_train, self.y_train, perm, self.mesh)

    def run_train_epoch(self) -> Dict[str, float]:
        """One pass over the epoch's batches (shuffled per SHUFFLE on the
        replicated cache, always on the sharded one); the logs are the mean
        over the steps."""
        self._maybe_reshuffle()
        self._epochs_run += 1
        batches = self._epoch_indices_sharded() if self.sharded else \
            self._epoch_indices(self.n_train, shuffle=self.shuffle)
        if len(batches) == 0:
            raise ValueError(
                f"device-cached epoch is empty: {self.n_train} examples < "
                f"BATCHSIZE {self.batch}")
        idx_dev = torch.from_numpy(batches).to(self.device)
        step_logs = [self.train_step(idxs) for idxs in idx_dev]
        return self._to_host({k: torch.stack([s[k] for s in step_logs]).mean()
                              for k in step_logs[0]})

    def run_eval_epoch(self) -> Dict[str, float]:
        """Every validation example once: the full batches, then the tail
        as one smaller batch (reference floor semantics would drop it); the
        epoch value is the example-weighted mean."""
        lb = self.local_batch
        batches = [np.tile(np.arange(s * lb, (s + 1) * lb), self.n_shards)
                   for s in range(self._val_steps)] if self.sharded else \
            list(self._epoch_indices(self.n_val, shuffle=False))
        step_logs, weights = [], []
        for idxs in batches:
            step_logs.append(self.eval_step(
                torch.from_numpy(np.asarray(idxs)).to(self.device)))
            weights.append(float(len(idxs)))
        if self._val_tail is not None:
            x, y, ids = self._val_tail
            step_logs.append(self.eval_batch(x, y, ids, self._val_masks,
                                             whole=True))
            weights.append(float(len(ids)))
        if not step_logs:
            return {}
        w = torch.tensor(weights, device=self.device)
        return self._to_host({
            k: (torch.stack([s[k] for s in step_logs]).float() * w).sum()
            / w.sum() for k in step_logs[0]})
