"""Optimisation ladder for the cine/3D fused train step — counterpart of
cmrtpu's ``tools/probe3d.py``.

    python -m cmrtpu_torch.tools.probe3d [--steps 10] [--frames 8] [--hw 224]
    python -m cmrtpu_torch.tools.probe3d --only base,remat1,remat_full,bn_bf16

cmrtpu's ladder of rows (REMAT 1, 2 and true, BN_BF16, the (2+1)D U-Net,
t-pooling, wider and shallower trunks, the slice-wise wrapper, batch
sizes) through the port's real fused cached step (``Trainer`` and
``DeviceCachedLoop.train_step``: gather, augmentation, heatmap targets
with K1, forward, backward, Adam) on seeded random cine caches. Each
probe row: slices/s and step ms from CUDA events over ``--steps`` steps
after ``--warmup``, and the peak memory of the row; each
``roofline:<name>`` row: one warm step counted (``roofline.count_step``),
GFLOP and GB per step, and with the probe row's step time TFLOP/s, GB/s
and their shares of the peaks. A row that fails (out of memory) is a row
with ``error``, as in cmrtpu. One JSON line per row, so a partial run
still reports, the card's name and power limit first and a markdown table
last.
"""

import argparse
import json
import time

import numpy as np
import torch

from cmrtpu_torch.tools.roofline import (add_device_args, card,
                                         cached_step, count_step,
                                         landmark_cache, roofline_fields,
                                         sync, time_steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--vols", type=int, default=16,
                    help="volumes per step in the base row")
    ap.add_argument("--only", default="",
                    help="comma-separated row names to run (default: all)")
    add_device_args(ap)
    args = ap.parse_args(argv)

    from cmrtpu_torch.predict.predictor import resolve_device

    device = resolve_device(args.device)
    info = card(device)
    rng = np.random.default_rng(0)
    t, hw = args.frames, args.hw
    a, b = int(hw * 0.27), int(hw * 0.71)
    only = [n for n in args.only.split(",") if n]
    base_cfg = {"DIM": [t, hw, hw], "F_SIZE": [3, 3, 3], "M_POOL": [1, 2, 2],
                "DEPTH": 4, "FILTERS": 32, "MASK_CLASSES": 2,
                "MASK_VALUES": [1, 2], "MIXED_PRECISION": True,
                "USE_UPSAMPLE": False, "SCALER": "MinMax",
                "AUGMENT": True, "AUGMENT_PROB": 0.8, "RANDOMROTATE": True,
                "SHIFTSCALEROTATE": True, "GRIDDISTORTION": True,
                "LEARNING_RATE": 1e-4, "SEED": 0}
    caches = {}  # n_vols -> (x, y)
    results = {}

    def get_cache(n_vols):
        if n_vols not in caches:
            caches[n_vols] = landmark_cache(rng, max(2 * n_vols, 48),
                                            (t, hw, hw), a, b)
        return caches[n_vols]

    def emit(name, row):
        results[name] = row
        print(json.dumps(row), flush=True)

    def release():
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def probe(name, overrides, vols=None):
        if only and name not in only:
            return
        n_vols = vols or args.vols
        cfg = dict(base_cfg, BATCHSIZE=n_vols, **overrides)
        row = {"row": name, "vols_per_step": n_vols}
        try:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            trainer, one_step = cached_step(cfg, *get_cache(n_vols), device,
                                            rng)
            t0 = time.perf_counter()
            for _ in range(args.warmup):
                one_step()
            sync(device)
            row["warmup_s"] = time.perf_counter() - t0
            step_ms = time_steps(one_step, args.steps, device)
            row["slices_per_sec"] = n_vols * t / (step_ms / 1e3)
            row["step_ms"] = step_ms
            if device.type == "cuda":
                row["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                    device)
            del trainer, one_step
        except (RuntimeError, ValueError) as e:  # OOM rows are data
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        release()
        emit(name, row)

    def roofline(name, overrides, vols=None):
        """One warm step of the variant counted; a variant that fails is a
        row, not an abort."""
        if only and name not in only:
            return
        row = {"row": f"roofline:{name}"}
        try:
            n_vols = vols or args.vols
            cfg = dict(base_cfg, BATCHSIZE=n_vols, **overrides)
            trainer, one_step = cached_step(cfg, *get_cache(n_vols), device,
                                            rng)
            one_step()
            sync(device)
            cost = count_step(one_step)
            row.update(roofline_fields(cost, results.get(name, {}).get(
                "step_ms"), device, args.peak_tflops, args.peak_gbps))
            del trainer, one_step
        except (RuntimeError, ValueError) as e:
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        release()
        emit(f"roofline:{name}", row)

    # --- the ladder, cmrtpu's rows --------------------------------------
    probe("base", {})
    roofline("base", {})
    probe("upsample_decoder", {"USE_UPSAMPLE": True})
    probe("remat1", {"REMAT": 1})
    probe("remat2", {"REMAT": 2})
    probe("remat_full", {"REMAT": True})
    probe("bn_bf16", {"BN_BF16": True})
    probe("2p1d", {"MODEL_VARIANT": "unet_2p1d"})
    roofline("2p1d", {"MODEL_VARIANT": "unet_2p1d"})
    probe("2p1d_bn_bf16", {"MODEL_VARIANT": "unet_2p1d", "BN_BF16": True})
    probe("2p1d_remat1", {"MODEL_VARIANT": "unet_2p1d", "REMAT": 1})
    probe("pool_t", {"M_POOL": [2, 2, 2]})
    probe("f64_d3", {"FILTERS": 64, "DEPTH": 3})
    roofline("f64_d3", {"FILTERS": 64, "DEPTH": 3})
    probe("f64_d4", {"FILTERS": 64, "DEPTH": 4})
    probe("f128_d2", {"FILTERS": 128, "DEPTH": 2})
    roofline("f128_d2", {"FILTERS": 128, "DEPTH": 2})
    probe("fsize_133", {"F_SIZE": [1, 3, 3]})
    probe("wrapper", {"MODEL_VARIANT": "wrapper"})
    roofline("wrapper", {"MODEL_VARIANT": "wrapper"})
    probe("wrapper_b32", {"MODEL_VARIANT": "wrapper"}, vols=32)
    probe("b8", {}, vols=8)
    probe("b24", {}, vols=24)
    probe("b32", {}, vols=32)
    probe("2p1d_b8", {"MODEL_VARIANT": "unet_2p1d"}, vols=8)
    probe("2p1d_b24", {"MODEL_VARIANT": "unet_2p1d"}, vols=24)
    probe("2p1d_b32", {"MODEL_VARIANT": "unet_2p1d"}, vols=32)

    print(f"\ndevice: {info['name']}, power limit {info['power_limit']}")
    print("| row | slices/s | step ms | peak GB | note |")
    print("|---|---|---|---|---|")
    for name, row in results.items():
        if name.startswith("roofline:"):
            continue
        peak = row.get("peak_memory_bytes")
        print(f"| {name} | {row.get('slices_per_sec', '-')} | "
              f"{row.get('step_ms', '-')} | "
              f"{'-' if peak is None else peak / 1e9} | "
              f"{row.get('error', '')} |")
    return results


if __name__ == "__main__":
    main()
