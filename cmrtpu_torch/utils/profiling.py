"""Named stages, counters, spans and device traces — counterpart of
``cmrtpu/utils/profiling.py``:

  * ``StageTimer`` — wall-clock stages with count / total / mean / max,
    thread-safe (the generator's thread pool reports into it); cmrtpu's
    ``summary()`` keys; counters beside them (``count``/``counts``); and
    each name's latest values in order (``recent``), so a reader can take
    the stats of a stretch of calls (a measured window) after the fact.
  * ``GLOBAL_TIMER`` — the process-wide store the spans and the pipeline
    stages (``generator/fix_preprocess``, ``generator/batch``) report into.
  * ``span(name, **args)`` — the port's one span primitive: its host
    duration into ``GLOBAL_TIMER``, an NVTX range once CUDA is
    initialised, and, only while a ``torch.profiler`` runs, a
    ``record_function`` range on the profiler's clock (the one Kineto
    aligns the card's kernels with). An exception raised in the body
    passes through unchanged.
  * ``trace(log_dir)`` — a ``torch.profiler`` trace of the wrapped region
    (host ops, and the card's kernels where CUDA is available), written as
    a Chrome trace under ``log_dir``.

The spans of the hot paths (``serve.*`` in ``predict/serving.py`` and
``preprocess_model_input``, ``train.*`` in ``FusedStep.train_batch`` and
``TrainState.train_step``) and the counters ``serve.rows_real`` /
``serve.rows_forwarded`` / ``serve.rows_preprocessed_device`` are what the
benchmark's per-layer metrics read.
The store's ``perf_counter`` times and a trace's times are on different
clocks and are never compared.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch

# values ``StageTimer.recent`` keeps a name: 512 KiB of float64 at most,
# committed only as they are written
HISTORY = 1 << 16


class StageTimer:
    """Accumulates wall-clock stats per named stage.

    >>> timer = StageTimer()
    >>> with timer.stage("decode"):
    ...     ...
    >>> timer.summary()["decode"]["count"]
    1
    """

    def __init__(self, history: int = HISTORY) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}
        self._counts: Dict[str, int] = {}
        self._history = int(history)
        self._recent: Dict[str, list] = {}  # name -> [ring, values added]

    def _note(self, name: str, value: float) -> None:
        ring = self._recent.get(name)
        if ring is None:
            ring = self._recent[name] = [np.empty(self._history), 0]
        ring[0][ring[1] % self._history] = value
        ring[1] += 1

    def add(self, name: str, seconds: float) -> None:
        """One occurrence of stage ``name`` that took ``seconds``."""
        with self._lock:
            s = self._stats.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += seconds
            s["max_s"] = max(s["max_s"], seconds)
            self._note(name, seconds)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            self._note(name, n)

    def counts(self) -> Dict[str, int]:
        """name -> the counter's total."""
        with self._lock:
            return dict(self._counts)

    def recent(self, name: str) -> np.ndarray:
        """The last ``history`` values added under ``name``, oldest
        first: a stage's durations in seconds, a counter's increments."""
        with self._lock:
            ring = self._recent.get(name)
            if ring is None:
                return np.empty(0)
            buf, n = ring
            if n <= self._history:
                return buf[:n].copy()
            k = n % self._history
            return np.concatenate([buf[k:], buf[:k]])

    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> {count, total_s, max_s, mean_s}."""
        with self._lock:
            return {name: dict(s, mean_s=s["total_s"] / max(1, s["count"]))
                    for name, s in self._stats.items()}

    def log(self, level: int = logging.INFO) -> None:
        for name, s in sorted(self.summary().items()):
            logging.log(level, "stage %-24s n=%-6d total=%8.3fs mean=%8.4fs "
                        "max=%8.4fs", name, s["count"], s["total_s"],
                        s["mean_s"], s["max_s"])

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._counts.clear()
            self._recent.clear()


GLOBAL_TIMER = StageTimer()


class span:
    """``with span("serve.read") as s: ...`` times the body into
    ``GLOBAL_TIMER`` under ``name``; ``s.t0``/``s.t1`` are its
    ``perf_counter`` readings and ``s.seconds`` their difference, so a
    caller's record and the store read the same clock. Once CUDA is
    initialised the body is an NVTX range too. While a ``torch.profiler``
    runs it is also a ``record_function`` range, a ``user_annotation`` in
    the trace; ``args`` (a study's stem, a step's number) ride in that
    range's name after a space, ``"serve.study stem=case01"``, since the
    trace keeps a ``record_function``'s own args only when it records
    shapes. With no profiler running no range is opened, which keeps a
    span to a few microseconds. Adds no synchronisation with the card."""

    __slots__ = ("name", "args", "t0", "t1", "_range", "_nvtx")

    def __init__(self, name: str, **args) -> None:
        self.name = name
        self.args = args
        self.t0 = self.t1 = 0.0
        self._range = None
        self._nvtx = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "span":
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if torch.autograd._profiler_enabled():
            label = " ".join([self.name] + [f"{k}={v}" for k, v
                                            in self.args.items()])
            self._range = torch.profiler.record_function(label)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        GLOBAL_TIMER.add(self.name, self.t1 - self.t0)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """``torch.profiler`` trace of the wrapped region: host ops, and CUDA
    kernels when CUDA is available, exported as a Chrome trace
    (``trace.json``, viewable in Perfetto or chrome://tracing) under
    ``log_dir``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
