"""The traced sub-window: ``torch.profiler`` (CUPTI) over a few seconds of
the cell's own loop after the measured window, reduced to device busy
time, time by kernel, and the longest idle gaps named by the host
operation running at the time.

The sub-window is the span of a ``bench_window`` range around the loop,
which ends in a synchronize; device activity is every kernel, copy and
set, clipped to it.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(step: Callable[[], None], seconds: float, tmp: str) -> Dict:
    """Run ``step`` for ``seconds`` under the profiler; returns the reduced
    trace with the number of steps run."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx, \
        record_function

    torch.cuda.synchronize()
    steps = 0
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function("bench_window"):
            t0 = time.perf_counter()
            while True:
                step()
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            torch.cuda.synchronize()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    out = reduce(events)
    out["steps"] = steps
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events: List[Dict]) -> Dict:
    """window_s, busy_s, kernels {name: [count, seconds]}, and the top
    device operations and idle gaps (microsecond trace times)."""
    window = [e for e in events if e.get("name") == "bench_window"
              and e.get("ph") == "X"
              and e.get("cat") != "gpu_user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no bench_window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:10]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cpu_op"))
    idle = []
    for a, b in gaps:
        name = "no host op"
        for s, t, n in host:  # the innermost op running at the gap's start
            if s > a:
                break
            if t >= a:
                name = n
        idle.append([name, (b - a) * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels,
            "breakdown": {"device_ops": [[n, v[1]] for n, v in top],
                          "idle_gaps": idle}}


def symbol(name: str) -> str:
    """A kernel's function name without return type, template arguments
    or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([A-Za-z_][\w:]*)", name)
    return m.group(1).split("::")[-1] if m else name


def kernel_time(trace: Dict, symbols) -> Tuple[int, float]:
    """Launches and device seconds of the kernels named ``symbols``."""
    n, s = 0, 0.0
    for name, (count, secs) in trace["kernels"].items():
        if symbol(name) in symbols:
            n += count
            s += secs
    return n, s
