"""Host batches to the card — counterpart of ``cmrtpu/parallel/prefetch.py``.

``numpy_prefetch`` is cmrtpu's producer thread: it drives a host iterable
(decode, gather, packing) ahead of the consumer through a bounded queue and
makes no CUDA call, so the card is only ever touched by the consumer.

``PutAhead`` takes the place of cmrtpu's ``prefetch_to_device``: the main
thread hands it a packed host batch, it copies the batch into a pinned
buffer and enqueues the ``non_blocking`` host-to-device copy on a side
stream, so the copy of batch N+1 runs while the step on batch N computes.
``take`` makes the current stream wait on that copy's event and ties the
device tensors to the current stream (``record_stream``), so the caching
allocator cannot hand their memory to another allocation while the step
still reads them. The pinned buffers form a ring of ``depth + 2`` slots;
a slot is written again only after its last copy's event has completed.
On the CPU there is nothing to pin or overlap: ``put`` returns copies.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, NamedTuple, Optional, Sequence

import torch

_SENTINEL = object()


def numpy_prefetch(data: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``data`` in a background thread, up to ``depth`` items ahead.
    The producer must make no CUDA call. Its exception is raised in the
    consumer; the sentinel reaches a live consumer even when the queue is
    full; a consumer that leaves early stops the producer."""
    if depth <= 0:
        yield from data
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def producer():
        try:
            for item in data:
                if stop.is_set():  # the consumer left: prepare no more
                    return
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            err.append(e)
        finally:
            # a lost sentinel would block a live consumer's get forever;
            # only a stopped consumer lets it drop
            while True:
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5)


class Staged(NamedTuple):
    """A batch whose copy to the device has been enqueued: its device
    tensors, the event recorded after the copy (None on the CPU) and the
    events around the copy on the side stream when timing is on."""
    tensors: List[torch.Tensor]
    done: Optional["torch.cuda.Event"]
    start: Optional["torch.cuda.Event"] = None


class PutAhead:
    """Pinned ring buffers and a side stream for host-to-device batch
    copies on ``device``; ``timing`` records events around each copy."""

    def __init__(self, device: torch.device, depth: int = 2,
                 timing: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.timing = timing
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._slots: List[Optional[dict]] = [None] * (max(depth, 0) + 2)
        self._next = 0

    def _slot_buffers(self, tensors: Sequence[torch.Tensor]):
        """The next slot's host buffers for these tensors, once the slot's
        previous copy has completed (allocated, pinned, on first use and
        when the shapes change)."""
        index = self._next
        self._next = (index + 1) % len(self._slots)
        slot = self._slots[index]
        if slot is not None and slot["done"] is not None:
            slot["done"].synchronize()
        want = [(t.shape, t.dtype) for t in tensors]
        if slot is None or slot["want"] != want:
            slot = {"want": want, "done": None, "host": [
                torch.empty(s, dtype=d, pin_memory=self.cuda)
                for s, d in want]}
            self._slots[index] = slot
        return slot

    def put(self, tensors: Sequence[torch.Tensor]) -> Staged:
        """Stage host tensors: copy them into a pinned slot and enqueue the
        copy to the device on the side stream. Returns at once."""
        slot = self._slot_buffers(tensors)
        for buf, t in zip(slot["host"], tensors):
            buf.copy_(t)
        if not self.cuda:
            return Staged([b.clone() for b in slot["host"]], None)
        start = torch.cuda.Event(enable_timing=True) if self.timing else None
        done = torch.cuda.Event(enable_timing=self.timing)
        with torch.cuda.stream(self.stream):
            if start is not None:
                start.record(self.stream)
            dev = [b.to(self.device, non_blocking=True)
                   for b in slot["host"]]
            done.record(self.stream)
        slot["done"] = done
        return Staged(dev, done, start)

    def take(self, staged: Staged) -> List[torch.Tensor]:
        """The staged device tensors, safe to read on the current stream."""
        if staged.done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged.done)
            for t in staged.tensors:
                t.record_stream(current)
        return staged.tensors

    def host_buffers(self) -> List[torch.Tensor]:
        """Every pinned (on the CPU: plain) host buffer of the ring."""
        return [b for s in self._slots if s is not None for b in s["host"]]
