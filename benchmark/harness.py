"""The benchmark's core: find a cell's configuration, traffic mix, driver,
limits and metric readers by the names in ``BENCHMARK.json``, run the
driver, read the metrics, and print the result.

Everything a cell is made of is a file found by name:

  configs/<config>.json      the configuration as run (``config`` key)
  traffic/<traffic>.json     the mix; its ``driver`` key names
  drivers/<driver>.py        the driver of an entry point (``run(ctx)``)
  limits/<cell>.json         the limit of each number the check compares
  metrics/<metric>.py        one reader per metric (``read(run)``)

so a later change adds a cell, a mix or a metric by adding files and
entries, never by editing one that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cmrtpu")


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec(root: str) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(spec: Dict, name: str) -> Dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: Dict, cell: str, per_layer: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or its per-layer ones: those without
    a ``workloads`` key and those that list the cell."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_file_module(path: str, name: str):
    """A module from a file whose name may hold dots (a metric's name)."""
    mod_name = "benchmark_file_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable:
    return load_file_module(os.path.join(HERE, "metrics", f"{name}.py"),
                            name).read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def limits_of(cell: str) -> Dict:
    """The cell's limits file: ``limits`` (the numbers compared, each with
    its limit) and ``control`` (the lower precision its control runs in)."""
    path = os.path.join(HERE, "limits", f"{cell}.json")
    return load_json(path) if os.path.exists(path) else {}


@dataclass
class Context:
    """What a driver gets: the cell, its configuration (the program's
    config dict, SEED set from the seed), traffic, limits, the control's
    precision, run settings and a scratch directory under TMPDIR."""
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    control: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmp: str
    t_start: float
    chips: int = 1
    faults: Dict[str, Any] = field(default_factory=dict)
    marks: List = field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note a set-up stage's end, in seconds since the process
        started."""
        import time
        self.marks.append((name, time.time() - self.t_start))


@dataclass
class Check:
    """One compared number beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
    """A check for each number the cell's limits name, and for no other:
    the limits file decides what is compared. A number the run did not
    give reads NaN, which fails."""
    return [Check(k, float(values.get(k, float("nan"))), float(limit))
            for k, limit in limits.items()]


def passes(checks: List[Check]) -> bool:
    """Correct: at least one number compared, and each within its
    limit."""
    return bool(checks) and all(c.ok for c in checks)


def context(root: str, cell_name: str, seed: int, seconds: float,
            trace: bool, device, t_start: float,
            config_override: Optional[Dict] = None,
            traffic_override: Optional[Dict] = None) -> Context:
    spec = benchmark_spec(root)
    cell = find_cell(spec, cell_name)
    cfg = dict(load_json(os.path.join(HERE, "configs",
                                      f"{cell['config']}.json"))["config"])
    cfg.update(config_override or {})
    cfg["SEED"] = int(seed)
    traffic = dict(load_json(os.path.join(HERE, "traffic",
                                          f"{cell['traffic']}.json")))
    traffic.update(traffic_override or {})
    tmp = tempfile.mkdtemp(prefix="bench_")
    check = limits_of(cell_name)
    return Context(cell=cell, config=cfg, traffic=traffic,
                   limits=check.get("limits", {}),
                   control=check.get("control", "float8_e4m3fn"),
                   seed=int(seed),
                   seconds=float(seconds), trace=bool(trace), device=device,
                   tmp=tmp, t_start=t_start, chips=int(cell["chips"]))


def read_metrics(spec: Dict, cell: str, run: Dict, per_layer: bool
                 ) -> Dict[str, Dict]:
    """Each metric's reader on the run; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in metrics_of(spec, cell, per_layer):
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden (whole names:
    ``cmrtpu_torch`` is not ``cmrtpu``)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    if dev.type == "cuda":
        import torch
        return int(torch.cuda.max_memory_allocated(dev))
    return 0


def empty_cache(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, config_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None,
             faults: Optional[Dict[str, Callable]] = None) -> Dict:
    """One run of a cell on ``device``, its scratch directory removed
    after; the tests drive this on the CPU at small sizes."""
    import shutil

    ctx = context(root, cell, seed, seconds, trace, device, t_start,
                  config_override, traffic_override)
    ctx.faults = dict(faults or {})
    try:
        return driver(ctx.traffic["driver"]).run(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
