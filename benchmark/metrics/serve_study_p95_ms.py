"""95th percentile (nearest rank) of the window's study times; a failed
study counts as infinitely late."""

import math


def read(run):
    lat = run.get("latencies_s")
    if not lat:
        return None
    s = sorted(lat)
    return 1e3 * s[max(0, math.ceil(0.95 * len(s)) - 1)]
