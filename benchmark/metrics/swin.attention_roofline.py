"""The forward's window attention against its roofline: the least time of
a step's attention (benchmark/counts/window_attention.py: the larger of
its FLOPs over 989 TFLOP/s and its bfloat16 bytes over 3.35 TB/s) over
the device time launched under ``swin.attention`` a step."""

from benchmark.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def read(run):
    t, work = run.get("trace") or {}, run.get("attention_work")
    s = (t.get("spans") or {}).get("swin.attention")
    if not s or not work or not t.get("steps") or s["device_total_s"] <= 0:
        return None
    bound = max(work["flops"] / BF16_FLOPS, work["bytes"] / HBM_BYTES_PER_S)
    return 100.0 * bound / (s["device_total_s"] / t["steps"])
