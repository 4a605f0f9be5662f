"""Model FLOP utilisation of serving: the reference model's forward FLOPs
of each served study's real slices (benchmark/counts/unet.py; the padding
of the last batch not counted), summed over the window, over the
window's seconds x 989 TFLOP/s (H100 bf16, dense)."""

from benchmark.counts.peaks import BF16_FLOPS


def read(run):
    if "forward_flops_per_slice" not in run:
        return None
    flops = sum(run["slices"]) * run["forward_flops_per_slice"]
    return 100.0 * flops / (run["window_s"] * run["chips"] * BF16_FLOPS)
