"""Median time of process_study over every study of the window (host
clock, nearest rank; a failed study counts as infinitely late)."""

import math


def percentile(values, q):
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def read(run):
    if not run.get("latencies_s"):
        return None
    return 1e3 * percentile(run["latencies_s"], 50)
