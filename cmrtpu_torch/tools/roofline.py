"""Roofline of the fused device-cached train step — counterpart of cmrtpu's
``tools/roofline.py``.

    python -m cmrtpu_torch.tools.roofline [--batch 128] [--steps 20] [--ws]

Builds the flagship 2D step (224², depth 4, 32 filters, bf16, the
transpose-conv decoder, augmentation on) through ``Trainer`` and
``DeviceCachedLoop.train_step`` on a seeded random cache, counts one warm
step, times ``--steps`` steps with CUDA events and prints the card's name
and power limit (``nvidia-smi``), the text lines cmrtpu's tool prints and
one JSON line.

XLA's cost analysis becomes two counts over one warm step (``count_step``):
FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, which counts the
convolutions (forward and both gradients) and matrix products and nothing
elementwise (``flop_ops`` names the ops it counted), and bytes accessed as
the sum over every aten op of the bytes of its tensor inputs and outputs,
the per-op sum XLA reports (views and allocations move nothing and are not
counted; neither are the kernels launched from ``ops/cuda_kernels.py``,
which are no aten ops). Peaks default to the published dense bf16 rate and
memory bandwidth of an H100 SXM, 989 TFLOP/s and 3,350 GB/s; set
``--peak-tflops`` / ``--peak-gbps`` for another card. ``--device cpu``
runs the same counts on the host at a small ``--hw``: its step time is a
host-clock time, and no share of a card's peak is printed for it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import types
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

H100_TFLOPS = 989.0   # dense bf16, H100 SXM data sheet
H100_GBPS = 3350.0    # HBM3, H100 SXM data sheet

# allocations move no data
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's distinct tensor inputs and
    outputs; views (outputs that alias an input) and allocations are
    skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False) or func in _NO_TRAFFIC:
            return out
        seen = set()
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.bytes += t.numel() * t.element_size()
        return out


def count_step(step: Callable[[], object]) -> Dict:
    """FLOPs and bytes accessed of one call of ``step`` (see the module
    docstring), and the ops the FLOP count covers, with their FLOPs."""
    flops = FlopCounterMode(display=False)
    moved = _ByteCounter()
    with flops, moved:
        step()
    by_op = {str(op).replace("aten.", ""): int(n) for op, n in
             flops.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(flops.get_total_flops()), "bytes": int(moved.bytes),
            "flop_ops": by_op}


def card(device: torch.device) -> Dict:
    """The device's name and power limit (``nvidia-smi``) on a card, or
    the host; prints nvidia-smi's line."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    line = line[device.index or 0] if line else ""
    print(line, flush=True)
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": line.split(",")[-1].strip() if line else None}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(step: Callable[[], object], steps: int,
               device: torch.device) -> float:
    """ms per call of ``step`` over ``steps`` calls: CUDA events on a
    card, the host clock (after a synchronise) elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    return (time.perf_counter() - t0) * 1e3 / steps


def cached_step(config: Dict, x_cache: np.ndarray, y_cache: np.ndarray,
                device: torch.device, rng: np.random.Generator):
    """(trainer, one_step) for ``config`` on a cache of (x, y) arrays held
    on ``device``: ``one_step()`` runs ``DeviceCachedLoop.train_step`` on
    a batch of random rows drawn from ``rng``."""
    from cmrtpu_torch.train.device_cache import DeviceCachedLoop
    from cmrtpu_torch.train.trainer import Trainer

    trainer = Trainer(config, device=device)
    gen = types.SimpleNamespace(_cache_x=x_cache, _cache_y=y_cache,
                                masks=True)
    loop = DeviceCachedLoop(trainer, gen)
    batch, n = int(config["BATCHSIZE"]), x_cache.shape[0]

    def one_step():
        idxs = torch.from_numpy(rng.integers(0, n, batch)).to(device)
        return loop.train_step(idxs)

    return trainer, one_step


def landmark_cache(rng: np.random.Generator, n: int, shape, a: int, b: int):
    """cmrtpu's probe caches: normal images, two 4-pixel-square landmarks
    (labels 1 and 2) at (a, a) and (b, b) on every frame."""
    x = rng.normal(size=(n, *shape)).astype(np.float32)
    y = np.zeros((n, *shape), np.float32)
    y[..., a:a + 4, a:a + 4] = 1.0
    y[..., b:b + 4, b:b + 4] = 2.0
    return x, y


def roofline_fields(cost: Dict, step_ms: Optional[float],
                    device: torch.device, peak_tflops: float,
                    peak_gbps: float) -> Dict:
    """GFLOP and GB per step, and with a card's step time the achieved
    TFLOP/s and GB/s and their shares of the peaks (none for the host)."""
    row = {"gflop_per_step": cost["flops"] / 1e9,
           "gb_per_step": cost["bytes"] / 1e9, "flop_ops": cost["flop_ops"]}
    if step_ms and device.type == "cuda":
        s = step_ms / 1e3
        row["tflops"] = cost["flops"] / 1e12 / s
        row["gbps"] = cost["bytes"] / 1e9 / s
        row["flop_share"] = row["tflops"] / peak_tflops
        row["byte_share"] = row["gbps"] / peak_gbps
    return row


def flagship_config(batch: int, hw: int, ws: bool) -> Dict:
    """cmrtpu's roofline config: the flagship 2D step at ``hw``², bf16,
    the transpose-conv decoder, augmentation on; ``ws`` the weight-
    standardised arm."""
    return {"DIM": [hw, hw], "DEPTH": 4, "FILTERS": 32, "MASK_CLASSES": 2,
            "BATCHSIZE": batch, "MIXED_PRECISION": True,
            "USE_UPSAMPLE": False, "MASK_VALUES": [1, 2], "SCALER": "MinMax",
            "AUGMENT": True, "AUGMENT_PROB": 0.8, "RANDOMROTATE": True,
            "SHIFTSCALEROTATE": True, "GRIDDISTORTION": True,
            "LEARNING_RATE": 1e-4, "SEED": 0,
            "WEIGHT_STANDARDISATION": ws, "WS_I_UNDERSTAND": ws,
            "BATCH_NORMALISATION": not ws}


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--peak-tflops", type=float, default=H100_TFLOPS,
                    help="bf16 peak, TFLOP/s (H100 SXM default)")
    ap.add_argument("--peak-gbps", type=float, default=H100_GBPS,
                    help="memory bandwidth peak, GB/s (H100 SXM default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked "
                         "for)")


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--ws", action="store_true",
                    help="roofline the WEIGHT_STANDARDISATION arm "
                         "(normalization-free scaled-WS convs)")
    add_device_args(ap)
    args = ap.parse_args(argv)

    from cmrtpu_torch.predict.predictor import resolve_device

    device = resolve_device(args.device)
    info = card(device)
    config = flagship_config(args.batch, args.hw, args.ws)
    rng = np.random.default_rng(0)
    n_cache = max(4 * args.batch, 512)
    a, b = int(args.hw * 60 / 224), int(args.hw * 160 / 224)
    x_cache, y_cache = landmark_cache(rng, n_cache, (args.hw, args.hw), a, b)
    trainer, one_step = cached_step(config, x_cache, y_cache, device, rng)

    for _ in range(3):
        one_step()
    sync(device)
    cost = count_step(one_step)
    sync(device)
    step_ms = time_steps(one_step, args.steps, device)
    row = {"tool": "roofline", "device": info["name"],
           "power_limit": info["power_limit"], "batch": args.batch,
           "hw": args.hw, "ws": args.ws, "step_ms": step_ms,
           "slices_per_s": args.batch / (step_ms / 1e3),
           **roofline_fields(cost, step_ms, device, args.peak_tflops,
                             args.peak_gbps)}
    print(f"device: {info['name']}  batch: {args.batch}")
    print(f"step time: {step_ms:.1f} ms   throughput: "
          f"{row['slices_per_s']:.0f} slices/s")
    print(f"counted: {row['gflop_per_step']:.1f} GFLOP "
          f"({', '.join(sorted(cost['flop_ops']))}), "
          f"{row['gb_per_step']:.2f} GB accessed per step")
    if "flop_share" in row:
        print(f"achieved: {row['tflops']:.1f} TFLOP/s "
              f"({100 * row['flop_share']:.0f}% of {args.peak_tflops:.0f} "
              f"peak)   {row['gbps']:.0f} GB/s "
              f"({100 * row['byte_share']:.0f}% of {args.peak_gbps:.0f} "
              "peak)")
        row["bound"] = "memory bandwidth" \
            if row["byte_share"] > row["flop_share"] else "compute"
        print(f"dominant bound: {row['bound']}")
    print(json.dumps(row), flush=True)
    del trainer
    return row


if __name__ == "__main__":
    main()
