"""Run one cell of the benchmark of cmrtpu_torch on the cards of this
machine and print its result as the last line of standard output:

    python3 -m benchmark.run --workload cine_3d.train --seed 7 \
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read in the same window and in a profiled sub-window
after it. The numbers that decide ``correct`` are printed beside their
limits as the last lines of standard error and under ``checks``, the last
key of the result. Without CUDA, with fewer cards than the cell asks for,
or with a JAX module loaded once the window has closed, the run exits
with another code than 0 and prints no result.
"""

import time

T_START = time.time()  # noqa: E402 - set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment(root: str, deployment: dict) -> None:
    """Every kernel cache at a fixed path inside the checkout (the
    program's CUDA library builds in cmrtpu_torch/_build by itself;
    anything Triton or torch's extension loader compiles goes here), and
    the host compute threads that the configuration's deployment states
    (``deployment.host_threads``; the libraries' defaults without it)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    threads = deployment.get("host_threads")
    if threads:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(int(threads))


def main(argv=None) -> int:
    args = _args(argv)
    root = os.getcwd()
    from benchmark import harness as H  # the standard library only

    spec = H.benchmark_spec(root)
    cell = H.find_cell(spec, args.workload)
    environment(root, H.load_json(os.path.join(
        H.HERE, "configs", f"{cell['config']}.json")).get("deployment", {}))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    run = H.run_cell(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), T_START)
    metrics = H.read_metrics(spec, args.workload, run, bool(args.trace))
    loaded = H.forbidden_modules()
    if loaded:
        print("forbidden modules loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    result = {"correct": bool(run["correct"]),
              "attempted": int(run["attempted"]),
              "failed": int(run["failed"]),
              "metrics": metrics,
              "device": run["device"]}
    if args.trace and run.get("breakdown"):
        result["breakdown"] = run["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in run["checks"]}
    for name, at in run.get("marks", []):
        print(f"setup {name} at {at:.3f} s", file=sys.stderr)
    for name, value in (run.get("readings") or {}).items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    for c in run["checks"]:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
