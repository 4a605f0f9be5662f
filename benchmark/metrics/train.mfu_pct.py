"""Model FLOP utilisation of training: the reference model's forward and
backward FLOPs at the cell's batch (benchmark/counts/unet.py, no
recompute) times the window's steps, over the window's seconds x cards x
989 TFLOP/s (H100 bf16, dense)."""

from benchmark.counts.peaks import BF16_FLOPS


def read(run):
    if "step_flops" not in run:
        return None
    return 100.0 * run["steps"] * run["step_flops"] / (
        run["window_s"] * run["chips"] * BF16_FLOPS)
