"""Throughput probe of the flagship 2D fused train step under config
overrides — counterpart of cmrtpu's ``tools/probe2d.py``.

    python -m cmrtpu_torch.tools.probe2d --set GROUP_NORM=16 --set BATCH_NORMALISATION=false
    python -m cmrtpu_torch.tools.probe2d --base --set WEIGHT_STANDARDISATION=true --set WS_I_UNDERSTAND=true

Builds cmrtpu's probe config (224², depth 4, 32 filters, bf16, the
transpose-conv decoder, augmentation on) with the overrides through
``Trainer`` and ``DeviceCachedLoop.train_step`` on a seeded random cache,
runs ``--warmup`` steps, times ``--steps`` with CUDA events and counts one
warm step (``roofline.count_step``). Prints the card's name and power limit
and one JSON line: {"overrides", "slices_per_sec", "step_ms",
"peak_memory_bytes", "roofline": {...}} and, with ``--base``, the same for
the unmodified step measured in the same process ("base_slices_per_sec",
"speedup", "base_roofline"): two versions compare only within one run.
"""

import argparse
import json

import numpy as np
import torch

from cmrtpu_torch.tools.roofline import (add_device_args, card,
                                         cached_step, count_step,
                                         flagship_config, landmark_cache,
                                         roofline_fields, sync, time_steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--base", action="store_true",
                    help="also measure the unmodified step in the same run")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    add_device_args(ap)
    args = ap.parse_args(argv)

    from cmrtpu_torch import config as C
    from cmrtpu_torch.predict.predictor import resolve_device

    device = resolve_device(args.device)
    info = card(device)
    base_cfg = flagship_config(args.batch, args.hw, ws=False)
    for key in ("WEIGHT_STANDARDISATION", "WS_I_UNDERSTAND",
                "BATCH_NORMALISATION"):
        del base_cfg[key]  # cmrtpu's probe config leaves them at defaults
    overrides = C.parse_override_pairs(args.set)
    rng = np.random.default_rng(0)
    n_cache = max(4 * args.batch, 512)
    a, b = int(args.hw * 60 / 224), int(args.hw * 160 / 224)
    x_cache, y_cache = landmark_cache(rng, n_cache, (args.hw, args.hw), a, b)

    def measure(cfg):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        trainer, one_step = cached_step(cfg, x_cache, y_cache, device, rng)
        for _ in range(args.warmup):
            one_step()
        sync(device)
        step_ms = time_steps(one_step, args.steps, device)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else None
        cost = count_step(one_step)
        del trainer, one_step
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return (args.batch / (step_ms / 1e3), step_ms, peak,
                roofline_fields(cost, step_ms, device, args.peak_tflops,
                                args.peak_gbps))

    rate, step_ms, peak, fields = measure(dict(base_cfg, **overrides))
    row = {"overrides": overrides, "slices_per_sec": rate,
           "step_ms": step_ms, "peak_memory_bytes": peak,
           "device": info["name"], "power_limit": info["power_limit"],
           "roofline": fields}
    if args.base:
        base_rate, _, _, base_fields = measure(dict(base_cfg))
        row["base_slices_per_sec"] = base_rate
        row["speedup"] = rate / base_rate
        row["base_roofline"] = base_fields
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
