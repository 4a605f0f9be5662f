"""Training from packed host-streamed batches — counterpart of
``cmrtpu/train/streaming.py``: the path for a dataset that does not fit
``DEVICE_CACHE_LIMIT_GB``, or a generator without its in-memory cache
(``cli.train -inmemory false``).

    host thread: DataGenerator.raw_batch -> packed batch (STREAM_DTYPE
                 images, uint8 masks)                      [numpy_prefetch]
    main thread: pinned copy -> copy to the card on a side stream, enqueued
                 before the step on the batch before it        [PutAhead]
    card:        the cached loop's fused step with the batch as its cache
                 and arange(B) as its indices: unpack -> [hist match
                 against the batch's rows] -> augment -> finalize (K1) ->
                 forward -> loss -> backward -> optimizer

At batch 16 and 224² a packed batch is 2.41 MB (bf16 images, uint8 masks)
against 9.6 MB of finalized float32 with two target channels.

``STREAM_ECHO: k`` takes k steps on each uploaded batch, each with fresh
augmentation and dropout draws from the trainer's generators (data
echoing, arXiv:1907.05550), and logs the mean of the k steps' logs; with
``AUGMENT`` off the echoes differ only by dropout, which is warned about.

Over W ranks each rank takes its block of rows of every global host
batch (cmrtpu's ``shard_batch``) and copies only those; the step is the
sharded one, with the matcher drawn once a shard for its first rows.

Backpressure: the logs of at most ``min(PREFETCH_DEPTH, QUEUE_SIZE)`` steps
stay in flight; past that the oldest's scalars are read, which waits for
that step to retire. The eval walks ``len(val_gen)`` full batches and
drops the remainder, as cmrtpu's streamed eval does.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Dict, Optional

import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.parallel.mesh import shard_batch
from cmrtpu_torch.parallel.prefetch import PutAhead, numpy_prefetch
from cmrtpu_torch.train.device_cache import FusedStep


class StreamedLoop(FusedStep):
    """Drives epochs over packed host-streamed batches for a Trainer, from
    DataGenerators (``raw_batch``, ``len``, ``on_epoch_end``).

    ``timeline``, when set to a list, receives one dict per batch of an
    epoch with the producer's host ms and CUDA events around the copy and
    the step(s) (the smoke run's measurements); None records nothing."""

    def __init__(self, trainer, train_gen, val_gen=None):
        super().__init__(trainer, getattr(train_gen, "masks", True),
                         first_rows=True)
        cfg = self.config
        self.train_gen = train_gen
        self.val_gen = val_gen
        self._echo = max(1, int(C.get(cfg, "STREAM_ECHO", 1) or 1))
        if self._echo > 1 and not self._augment:
            logging.warning(
                "STREAM_ECHO=%d with AUGMENT=False: echoed steps repeat the "
                "same finalized batch (only dropout varies); echoing is "
                "meant to pair with on-device augmentation", self._echo)
        depth = int(C.get(cfg, "PREFETCH_DEPTH", 2))
        queue_size = C.get(cfg, "QUEUE_SIZE")
        self._depth = min(depth, int(queue_size)) if queue_size else depth
        # row r of each rank's block (cmrtpu's tiled local index row)
        self._idxs = torch.arange(self.local_batch,
                                  device=self.device).repeat(self.mesh.data)
        self.put_ahead = PutAhead(self.device, self._depth)
        self.timeline: Optional[list] = None
        logging.info("streamed loop: packed host batches (STREAM_DTYPE=%s), "
                     "prefetch depth %d, echo %d",
                     C.get(cfg, "STREAM_DTYPE", "bfloat16"), self._depth,
                     self._echo)

    def _batches(self, gen):
        """The producer: the rank's rows of the packed batches of ``gen``
        (run in its thread)."""
        for i in range(len(gen)):
            t0 = time.perf_counter()
            imgs, msks = gen.raw_batch(i)
            if imgs.shape[0] != self.batch:
                raise ValueError(
                    f"raw_batch({i}) has {imgs.shape[0]} rows but the "
                    f"streamed step takes BATCHSIZE {self.batch}")
            yield (shard_batch((imgs, msks), self.mesh),
                   (time.perf_counter() - t0) * 1e3)

    def _event(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _pipelined(self, gen, consume: Callable) -> Dict[str, float]:
        """Put-ahead pipeline over ``gen``: the copy of batch N+1 is
        enqueued before the step on batch N is launched; at most ``depth``
        steps' logs stay unread. Returns the mean logs over the batches."""
        timed = self.timeline is not None and self.device.type == "cuda"
        self.put_ahead.timing = timed
        sums: Dict[str, float] = {}
        count = 0
        pending = None
        inflight: deque = deque()

        def drain(limit: int) -> None:
            nonlocal count
            while len(inflight) > limit:
                for key, value in self._to_host(inflight.popleft()).items():
                    sums[key] = sums.get(key, 0.0) + value
                count += 1

        def run(item) -> None:
            staged, record = item
            if timed:
                record["step_start"] = self._event()
            batch = self.put_ahead.take(staged)
            if timed:  # reached once the wait for the copy is over
                record["compute_start"] = self._event()
            inflight.append(consume(batch))
            if timed:
                record["step_end"] = self._event()

        for batch, producer_ms in numpy_prefetch(self._batches(gen),
                                                 depth=self._depth):
            staged = self.put_ahead.put(batch)
            record = {"producer_ms": producer_ms,
                      "bytes": sum(t.numel() * t.element_size()
                                   for t in batch)}
            if timed:
                record.update(copy_start=staged.start, copy_end=staged.done)
            if self.timeline is not None:
                self.timeline.append(record)
            if pending is not None:
                run(pending)
                drain(self._depth)
            pending = (staged, record)
        if pending is not None:
            run(pending)
        drain(0)
        return {k: v / max(count, 1) for k, v in sums.items()}

    def run_train_epoch(self) -> Dict[str, float]:
        def consume(batch):
            imgs, msks = batch
            logs = [self.train_batch(imgs, msks, self._idxs)
                    for _ in range(self._echo)]
            if self._echo == 1:
                return logs[0]
            return {k: torch.stack([s[k].float() for s in logs]).mean()
                    for k in logs[0]}

        means = self._pipelined(self.train_gen, consume)
        self.train_gen.on_epoch_end()
        return means

    def run_eval_epoch(self) -> Dict[str, float]:
        masks = bool(getattr(self.val_gen, "masks", True))

        def consume(batch):
            imgs, msks = batch
            return self.eval_batch(imgs, msks, self._idxs, masks)

        return self._pipelined(self.val_gen, consume)
