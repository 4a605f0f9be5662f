"""K1 (csrc/gaussian_blur.cu) against its roofline: the least time of one
call at the step's shape (benchmark/counts/k1_blur.py: the larger of its
bytes over 3.35 TB/s and its FLOPs over 67 TFLOP/s) over the kernel's
device time per launch in the traced sub-window."""

from benchmark.counts import k1_blur
from benchmark.counts.peaks import FP32_FLOPS, HBM_BYTES_PER_S
from benchmark.trace import kernel_time

SYMBOLS = ("gaussian_blur_kernel",)


def read(run):
    t, call = run.get("trace"), run.get("k1_call")
    if not t or not call:
        return None
    launches, secs = kernel_time(t, SYMBOLS)
    if not launches or secs <= 0:
        return None
    p, h, w = call["planes"], call["h"], call["w"]
    bound = max(k1_blur.bytes_moved(p, h, w) / HBM_BYTES_PER_S,
                k1_blur.flops(p, h, w, call["sigma"]) / FP32_FLOPS)
    return 100.0 * bound / (secs / launches)
