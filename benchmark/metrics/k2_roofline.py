"""K2 (csrc/cc_labels.cu) against its roofline: 5 bytes a pixel of each
stacked call [2 z, 224, 224] of the traced sub-window over 3.35 TB/s
(benchmark/counts/k2_cc.py), over the summed device time of K2's three
kernels."""

from benchmark.counts import k2_cc
from benchmark.counts.peaks import HBM_BYTES_PER_S
from benchmark.trace import kernel_time

SYMBOLS = ("cc_local_kernel", "cc_merge_kernel", "cc_flatten_kernel")


def read(run):
    t, calls = run.get("trace"), run.get("traced_k2_calls")
    if not t or not calls:
        return None
    launches, secs = kernel_time(t, SYMBOLS)
    if not launches or secs <= 0:
        return None
    bound = sum(k2_cc.bytes_moved(c["planes"], c["h"], c["w"])
                for c in calls) / HBM_BYTES_PER_S
    return 100.0 * bound / secs
