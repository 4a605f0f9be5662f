"""Driver of the Swin-Unet's device-cached training step,
``cmrtpu_torch.train.device_cache.DeviceCachedLoop.train_step`` with
MODEL_VARIANT 'swin_unet'.

As ``drivers/train.py`` runs the U-Net (its ``Feed``, ``cohort``,
``build``, ``readings`` and ``_gaps`` are used as they are), with the
Swin-Unet's own reference (``reference/swin_unet.py``), weights and
counts. The program's model is built before the cohort, so a program
without the variant fails at once. A traced run keeps the trace's split by
span (``spans.reduce``) as ``trace["spans"]``.

Compared (the numbers ``limits/<cell>.json`` names), after the window and
with the program's state freed, against the reference's first three
steps on the same rows, weights and draws: ``_gaps``' numbers and
  logit_row_worst_gap       over the rows of the first step's batch, the
                            worst of the norm of the gap between the
                            program's head logits (a forward hook on its
                            ``output`` conv) and the reference's, over the
                            norm of the reference's row;
  logit_grad_row_worst_gap  the same for the loss's gradient with respect
                            to those logits (a hook on the tensor): a loss
                            that leaves out or reweighs rows reads about 1;
  grad_half_ratio           over the leaves, the median of the norm of
                            the first gradient's gap to the reference's,
                            over the norm of the gap between the
                            reference's gradient with the loss over the
                            first half of the rows and its whole one: a
                            half batch reads 1.

Calibration (not run by the benchmark's runs): the numbers for the
program, the control and each planted fault over seeds, one JSON line each
on standard output:

    python3 -m benchmark.drivers.train_swin --seeds 11,12 \\
        --mode program --mode control --mode unchanged --mode half_batch
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark import faults as F
from benchmark import harness as H
from benchmark import spans as S
from benchmark import trace as T
from benchmark.counts import window_attention
from benchmark.counts.swin_unet import train_step_flops
from benchmark.drivers.train import (CHECK_STEPS, WARM_STEPS, Feed, _gaps,
                                     _images_per_step, build, cohort,
                                     device_info, readings)
from benchmark.reference import swin_unet as RS


def _profile(step, seconds: float, tmp: str, dev) -> Dict:
    """``trace.profile``'s traced sub-window, with the split by span; on
    the CPU (the tests) the trace holds the host's events only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    H.sync(dev)
    steps = 0
    with profile(activities=activities) as prof:
        with record_function("bench_window"):
            t0 = time.perf_counter()
            while True:
                step()
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            H.sync(dev)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    out = T.reduce(events)
    out["spans"] = S.reduce(events)
    out["steps"] = steps
    return out


def _head_capture(model):
    """A forward hook on the model's head conv that keeps the first call's
    logits and their gradient, channels last, on the host."""
    got: Dict[str, torch.Tensor] = {}

    def keep_grad(g):
        got["logit_grad"] = g.detach().movedim(1, -1).float().cpu()

    def hook(module, args, out):
        if "logits" not in got:
            got["logits"] = out.detach().movedim(1, -1).float().cpu()
            out.register_hook(keep_grad)

    return got, model.output.register_forward_hook(hook)


def _row_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst row's ||a_i - b_i|| / ||b_i||, on the host."""
    a, b = a.flatten(1).double().cpu(), b.flatten(1).double().cpu()
    return float(((a - b).norm(dim=1)
                  / b.norm(dim=1).clamp_min(1e-30)).max())


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number the check reads (module docstring)."""
    out = _gaps(prog, ref)
    out["logit_row_worst_gap"] = _row_gap(prog["logits"], ref["logits"])
    out["logit_grad_row_worst_gap"] = _row_gap(prog["logit_grad"],
                                               ref["logit_grad"])
    ratios = []
    for k, g in ref["grad"].items():
        g = g.cpu().double()
        gap = float((prog["grad"][k].cpu().double() - g).norm())
        half = float((ref["grad_half"][k].cpu().double() - g).norm())
        ratios.append(gap / max(half, 1e-30))
    out["grad_half_ratio"] = float(np.median(ratios))
    return out


def reference_steps(cfg: Dict, seed: int, weights, x, y, rows, dev,
                    quant=None) -> Dict:
    """The reference's first steps over the cohort on ``rows``, in float32
    with TF32 off, or in ``quant``."""
    data_x = torch.from_numpy(x).to(dev)
    if str(cfg.get("CACHE_DTYPE", "float32")).lower() in ("bfloat16",
                                                           "bf16"):
        data_x = data_x.to(torch.bfloat16).float()
    data_y = torch.from_numpy(y).to(dev)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return RS.run_steps(cfg, seed, weights, data_x, data_y, rows,
                            quant=quant)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def run(ctx: H.Context) -> Dict:
    from cmrtpu_torch import config as C
    from cmrtpu_torch.models.hybrids import get_model

    cfg, dev = ctx.config, ctx.device
    ctx.mark("start")
    with torch.device("meta"):  # a program without the model fails here
        get_model(C.normalise_config(dict(cfg)))
    x, y = cohort(ctx)
    ctx.mark("cohort")
    weights = RS.make_weights(cfg, ctx.seed, dev)
    trainer, loop = build(ctx, weights, x, y)
    ctx.mark("build")
    for fault in ctx.faults.values():
        fault(trainer, loop)
    batch = int(cfg["BATCHSIZE"])
    feed = Feed(len(x), batch, ctx.seed, dev)
    first = [feed.next()[0] for _ in range(CHECK_STEPS)]
    rows = np.stack([r.cpu().numpy() for r in first])
    got, handle = _head_capture(trainer.model)
    prog = readings(trainer, loop, rows, weights)
    handle.remove()
    prog.update(got)
    ctx.mark("check_steps")
    for _ in range(WARM_STEPS):
        loop.train_step(feed.next()[0])
    H.sync(dev)
    ctx.mark("warm_steps")

    H.reset_peak(dev)
    t_window = time.time()
    t0 = time.perf_counter()
    steps, epoch_logs = 0, []
    while True:
        row, last = feed.next()
        epoch_logs.append(loop.train_step(row))
        steps += 1
        if last:  # the epoch's mean logs, one transfer (run_train_epoch)
            torch.stack([torch.stack([s[k] for s in epoch_logs]).float()
                         .mean() for k in epoch_logs[0]]).tolist()
            epoch_logs = []
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    H.sync(dev)
    window_s = time.perf_counter() - t0
    peak = H.peak_bytes(dev)

    traced = None
    if ctx.trace:
        traced = _profile(lambda: loop.train_step(feed.next()[0]),
                          float(ctx.traffic.get("trace_seconds", 2.0)),
                          ctx.tmp, dev)
    del trainer, loop, epoch_logs
    gc.collect()
    H.empty_cache(dev)

    ref = reference_steps(cfg, ctx.seed, weights, x, y, rows, dev)
    values = numbers(prog, ref)
    checks = H.checks_from(values, ctx.limits)
    dim = cfg["DIM"]
    return {
        "correct": H.passes(checks),
        "attempted": steps, "failed": 0,
        "setup_s": t_window - ctx.t_start,
        "window_s": window_s, "steps": steps,
        "images": steps * _images_per_step(cfg),
        "step_flops": train_step_flops(cfg, batch),
        "attention_work": window_attention.forward_work(cfg, batch),
        "k1_call": {"planes": batch * len(cfg["MASK_VALUES"]),
                    "h": int(dim[-2]), "w": int(dim[-1]),
                    "sigma": float(cfg["SIGMA"])},
        "chips": ctx.chips,
        "memory_peak_bytes": peak,
        "trace": traced,
        "breakdown": traced["breakdown"] if traced else None,
        "device": device_info(ctx, peak, traced),
        "checks": checks,
        "readings": values,
        "marks": ctx.marks,
    }


def control(ctx: H.Context) -> Dict[str, float]:
    """Every number the check reads when the reference in a lower
    precision stands in for the program, on the rows a run would train
    first; the check has to reject them."""
    cfg, dev, quant = ctx.config, ctx.device, RS.QUANTS[ctx.control]
    x, y = cohort(ctx)
    weights = RS.make_weights(cfg, ctx.seed, dev)
    feed = Feed(len(x), int(cfg["BATCHSIZE"]), ctx.seed, dev)
    rows = np.stack([feed.next()[0].cpu().numpy()
                     for _ in range(CHECK_STEPS)])
    ref = reference_steps(cfg, ctx.seed, weights, x, y, rows, dev)
    low = reference_steps(cfg, ctx.seed, weights, x, y, rows, dev, quant)
    return numbers(low, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Readings that set the "
                                "Swin-Unet cell's limits")
    p.add_argument("--workload", default="swin_unet_2d.train")
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", action="append", required=True,
                   help="program, control, or a fault of faults.TRAIN")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control", default=None,
                   help="the control's precision, if not the limits'")
    p.add_argument("--set", action="append", default=[],
                   help="KEY=JSON: a configuration value")
    args = p.parse_args(argv)
    root, dev = os.getcwd(), torch.device(args.device)
    override = {k: json.loads(v) for k, v in
                (kv.split("=", 1) for kv in args.set)}
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.mode:
            t0 = time.time()
            if mode == "control":
                ctx = H.context(root, args.workload, seed, 0, False, dev,
                                t0, override)
                ctx.control = args.control or ctx.control
                try:
                    values = control(ctx)
                finally:
                    shutil.rmtree(ctx.tmp, ignore_errors=True)
                correct = H.passes(H.checks_from(values, ctx.limits))
            else:
                faults = {} if mode == "program" else {mode: F.TRAIN[mode]}
                result = H.run_cell(root, args.workload, seed, args.seconds,
                                    False, dev, t0, override, faults=faults)
                values, correct = result["readings"], result["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": values,
                              "correct": correct,
                              "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
