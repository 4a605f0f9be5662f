"""The program's spans in a profiler trace, and its span store.

``reduce(events)`` reads the Kineto events of the traced sub-window
(``trace.profile``): every ``user_annotation`` range but ``bench_window``
is a span, named by its range's name up to the first space (the program's
``profiling.span`` writes its args after one). Device work (kernels,
copies and sets, clipped to the window) goes to the innermost span open
when its runtime call launched it, matched through the ``correlation``
arg; device idle time (the window less the union of that work) to the
innermost span open at the time, or to ``no span``. Spans are matched by
time, not thread: autograd launches the backward from a thread of its own
while the caller sits in ``train.backward``. Innermost is the open span
that started last.

``window(name, n, after)`` reads the program's own span store
(``GLOBAL_TIMER``) after a run: the latest values it keeps a name
(``recent``) hold the measured window's just before the traced
sub-window's, and the run says how many of each there are. A program
whose store keeps no history gives None.

No harness file calls ``reduce`` yet: ``trace.profile`` keeps only its
own reduction of the events (PERF.md, Open questions).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "no span"


def _window(events: List[Dict]) -> Tuple[float, float]:
    for e in events:
        if e.get("name") == "bench_window" and e.get("ph") == "X" \
                and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise RuntimeError("the trace holds no bench_window range")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _segments(spans: List[Tuple[float, float, str]]):
    """Cut the time line at every span boundary: ([segment starts],
    [(start, end, innermost name, names open)]), the segments in order;
    a segment with no span open is left out."""
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    by_start = sorted(spans)
    segs, open_, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(by_start) and by_start[k][0] <= a:
            open_.append(by_start[k])
            k += 1
        open_ = [s for s in open_ if s[1] > a]
        if open_:
            inner = max(open_, key=lambda s: (s[0], -s[1]))
            segs.append((a, b, inner[2], {s[2] for s in open_}))
    return [s[0] for s in segs], segs


def _at(starts, segs, t: float):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i]
    return None


def reduce(events: List[Dict]) -> Dict[str, Dict[str, float]]:
    """{name: {count, host_s, device_s, device_total_s, idle_s}} over the
    traced window: ``count`` the spans that start in it, ``host_s`` their
    time on the host (clipped to it), ``device_s`` the device work whose
    innermost span it is, ``device_total_s`` the device work launched
    while it was open (its nested spans' included), ``idle_s`` the device
    idle time whose innermost span it is. ``no span`` holds the device
    work and idle time outside every span."""
    w0, w1 = _window(events)
    spans, launched = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation" and e["name"] != "bench_window":
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            a, b = max(a, w0), min(b, w1)
            if b > a:
                spans.append((a, b, str(e["name"]).split(" ")[0]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    out: Dict[str, Dict[str, float]] = {}

    def entry(name):
        return out.setdefault(name, {"count": 0, "host_s": 0.0,
                                     "device_s": 0.0, "device_total_s": 0.0,
                                     "idle_s": 0.0})

    for a, b, name in spans:
        s = entry(name)
        s["count"] += 1
        s["host_s"] += (b - a) * 1e-6
    starts, segs = _segments(spans)
    busy = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        busy.append((a, b))
        t = launched.get((e.get("args") or {}).get("correlation"))
        seg = _at(starts, segs, t) if t is not None else None
        secs = (b - a) * 1e-6
        entry(seg[2] if seg else NO_SPAN)["device_s"] += secs
        for name in seg[3] if seg else (NO_SPAN,):
            entry(name)["device_total_s"] += secs
    busy = _union(busy)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    for a, b in idle:  # each idle stretch split at the span boundaries
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        t = a
        while t < b:
            seg = segs[i] if i < len(segs) else None
            if seg is None or seg[0] >= b:
                entry(NO_SPAN)["idle_s"] += (b - t) * 1e-6
                break
            if seg[1] <= t:
                i += 1
                continue
            if seg[0] > t:
                entry(NO_SPAN)["idle_s"] += (seg[0] - t) * 1e-6
                t = seg[0]
            end = min(seg[1], b)
            entry(seg[2])["idle_s"] += (end - t) * 1e-6
            t = end
            i += 1
    return out


def window(name: str, n: int, after: int) -> Optional[np.ndarray]:
    """The ``n`` values the program's span store (``GLOBAL_TIMER``) took
    under ``name`` before its last ``after``: the measured window's, where
    ``after`` are the traced sub-window's. None from a program whose store
    keeps no history, or too little of it."""
    from cmrtpu_torch.utils.profiling import GLOBAL_TIMER

    recent = getattr(GLOBAL_TIMER, "recent", None)
    if recent is None or n <= 0:
        return None
    values = recent(name)
    if len(values) < n + after:
        return None
    return values[len(values) - after - n:len(values) - after]


def serve_window(run: Dict, name: str, per_slice: bool = False
                 ) -> Optional[np.ndarray]:
    """A serving run's window values under ``name``, one a study (one a
    slice with ``per_slice``). The driver serves its warm-up studies, then
    the window's (``records``, with ``slices``), then the traced ones (one
    ``traced_k2_calls`` entry each, of 2 z planes), so the window's values
    lie just before the traced ones. None after a failed study, or where
    the store's ``serve.study`` times there are not the records' own."""
    recs = run.get("records")
    if run.get("failed") or not recs or "slices" not in run:
        return None
    traced = [c["planes"] // 2 for c in run.get("traced_k2_calls") or []]
    study = window("serve.study", len(recs), len(traced))
    if study is None or [round(float(t), 4) for t in study] != \
            [r["total_s"] for r in recs]:
        return None
    if per_slice:
        return window(name, int(sum(run["slices"])), int(sum(traced)))
    return window(name, len(recs), len(traced))


def serve_ms(run: Dict, name: str, per_slice: bool = False
             ) -> Optional[float]:
    """The window's host time under ``name`` in ms a study."""
    values = serve_window(run, name, per_slice)
    if values is None:
        return None
    return 1e3 * float(values.sum()) / len(run["records"])
