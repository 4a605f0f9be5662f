"""Named stages, device traces and trace ranges — counterpart of
``cmrtpu/utils/profiling.py``:

  * ``StageTimer`` — wall-clock stages with count / total / mean / max,
    thread-safe (the generator's thread pool reports into it); cmrtpu's
    ``summary()`` keys.
  * ``GLOBAL_TIMER`` — the process-wide timer the pipeline stages report
    into (``generator/fix_preprocess``, ``generator/batch``).
  * ``trace(log_dir)`` — a ``torch.profiler`` trace of the wrapped region
    (host ops, and the card's kernels where CUDA is available), written as
    a Chrome trace under ``log_dir``.
  * ``annotate(name)`` — a named range inside that trace
    (``record_function``) and, once CUDA is initialised, an NVTX range.
    An exception raised in the body passes through unchanged.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator

import torch


class StageTimer:
    """Accumulates wall-clock stats per named stage.

    >>> timer = StageTimer()
    >>> with timer.stage("decode"):
    ...     ...
    >>> timer.summary()["decode"]["count"]
    1
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stats.setdefault(
                    name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                s["count"] += 1
                s["total_s"] += dt
                s["max_s"] = max(s["max_s"], dt)

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


GLOBAL_TIMER = StageTimer()


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in a running ``trace`` (a no-op cost when none runs)
    and, once CUDA is initialised, an NVTX range for external profilers."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
