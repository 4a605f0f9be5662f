"""Strip-height sweep of K1 (``csrc/gaussian_blur.cu``) on one CUDA card.

    python -m cmrtpu_torch.tools.k1_sweep [--reps 50] [--replays 5]

For sigma 1, 2 and 4 (radii 4, 8 and 16) at the training path's
[32, 224, 224], launches the blur kernel with blocks of 32, 28, 24, 16 and 8
full-width rows, checks each output equal to the wrapper's, and times one
launch from CUDA events around replays of a CUDA graph of ``--reps``
launches (median, min and max over ``--replays`` replays). Prints the card's
name and power limit, ptxas's registers and spills, then one JSON line per
sigma. This is the measurement behind ``cuda_kernels.BLUR_STRIP_ROWS``;
rerun it when the kernel changes. Exits non-zero on a host without CUDA.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from cmrtpu_torch.ops import cuda_kernels as kernels

SHAPE = (32, 224, 224)  # batch 16 x 2 heatmap channels
SIGMAS = (1.0, 2.0, 4.0)
STRIPS = (32, 28, 24, 16, 8)


def graph_us(fn, reps, replays):
    """Microseconds per call of ``fn``: CUDA events around each of
    ``replays`` replays of one CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times)}


def sweep(x, sigma, reps, replays):
    """Time of one launch at each strip height, the wrapper's output as the
    reference (launches here are not counted)."""
    taps = kernels._blur_taps(float(sigma), 4.0)
    _, h, w = x.shape
    _, chunk = kernels.blur_geometry(h, w, (taps[0].size - 1) // 2)
    ref = kernels.gaussian_blur_2d_cuda(x, sigma)
    times = {}
    for strip in STRIPS:
        out = torch.empty_like(x)

        def launch():
            kernels._launch_blur(x, out, taps, strip, chunk)

        launch()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise RuntimeError(f"sigma {sigma}, strip {strip}: the output "
                               "differs from the wrapper's")
        times[strip] = graph_us(launch, reps, replays)
    return times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--replays", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
        flush=True)
    report = kernels.build()
    print(json.dumps({"ptxas": [line.strip() for line in report.splitlines()
                                if "registers" in line or "spill" in line]}),
          flush=True)
    x = torch.from_numpy(np.random.default_rng(0).random(
        SHAPE, np.float32)).cuda()
    for sigma in SIGMAS:
        print(json.dumps({"shape": list(SHAPE), "sigma": sigma,
                          "strip_rows_default": kernels.BLUR_STRIP_ROWS,
                          "graph_us": sweep(x, sigma, args.reps,
                                            args.replays)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
