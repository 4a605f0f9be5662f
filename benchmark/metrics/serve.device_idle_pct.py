"""Share of the measured window in which the card ran no kernel, copy or
set: the device busy time a study, the union of those intervals over the
traced sub-window divided by its studies, times the window's finished
studies, over the window's seconds. The profiler slows the host, so the
sub-window's own idle share (the result's busy_s and window_s) reads
higher."""


def read(run):
    t = run.get("trace")
    if not t or "latencies_s" not in run or not t["steps"]:
        return None
    busy = t["busy_s"] / t["steps"] * len(run["records"])
    return 100.0 * (1.0 - busy / run["window_s"])
