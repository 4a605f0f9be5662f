"""Readings that set a cell's limits (not run by the benchmark's runs):
the numbers the correctness check compares, for the program on many
seeds, for the control (the reference in the next lower precision, here
the precision its limits file names) and for each planted fault,
all in one process:

    python3 -m benchmark.calibrate --workload cine_3d.train \
        --seeds 11,12,13 --mode program --mode control --mode half_batch

One JSON line per seed and mode on standard output.
"""

import argparse
import json
import os
import shutil
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", action="append", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[],
                   help="KEY=JSON: a configuration value for a look at "
                        "what a number depends on")
    args = p.parse_args(argv)
    import torch

    from benchmark import faults as F
    from benchmark import harness as H

    root = os.getcwd()
    dev = torch.device(args.device)
    override = {k: json.loads(v) for k, v in
                (kv.split("=", 1) for kv in args.set)}
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.mode:
            t0 = time.time()
            if mode == "control":
                ctx = H.context(root, args.workload, seed, 0, False, dev, t0,
                                override)
                numbers = H.driver(ctx.traffic["driver"]).control(ctx)
                shutil.rmtree(ctx.tmp, ignore_errors=True)
                correct = H.passes(H.checks_from(numbers, ctx.limits))
            else:
                spec = H.find_cell(H.benchmark_spec(root), args.workload)
                kind = H.load_json(os.path.join(
                    H.HERE, "traffic", f"{spec['traffic']}.json"))["driver"]
                table = F.TRAIN if kind == "train" else F.SERVE
                faults = {} if mode == "program" else {mode: table[mode]}
                run = H.run_cell(root, args.workload, seed, args.seconds,
                                 False, dev, t0, override, faults=faults)
                numbers = run["readings"]
                correct = run["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "correct": correct,
                              "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
