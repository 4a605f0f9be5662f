"""Driver of the device-cached training step,
``cmrtpu_torch.train.device_cache.DeviceCachedLoop.train_step``.

Set-up makes the cohort and the weights from the seed, builds the
program's Trainer and loop over the cohort (uploaded to the card in the
configured cache dtype) and drives that one loop through its first steps
on epoch-shuffled rows, laid out as ``run_train_epoch`` lays them out: a
[steps, B] permutation of the rows an epoch, uploaded once an epoch, the
epoch's mean logs brought to the host once. Steps 1-3 give the readings
the reference is held to; the window then runs the same loop closed, one
step after the other, for the run's seconds, and ends in a synchronize.

Compared (the numbers ``limits/<cell>.json`` names), after the window and
with the program's state freed, against the reference's first three steps
on the same rows, weights and draws:
  grad_median_gap    over the leaves, the median of the gap between the
                     norms of the first step's gradient (as the optimizer
                     got it) and the reference's, each over the larger of
                     the reference leaf's norm and the median leaf's;
  change_median_gap  the same for the parameters' change over the three
                     steps, leaving out leaves whose reference gradient is
                     under a thousandth of the median leaf's.
The losses' gaps, the worst leaf's, and the norms of each leaf's
difference (``*_diff``) are read and printed beside them.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import harness as H
from benchmark import trace as T
from benchmark.counts.unet import train_step_flops
from benchmark.reference import train as R
from benchmark.reference.unet import QUANTS
from benchmark.traffic import generator as G
from benchmark.weights import make_weights

CHECK_STEPS = 3
WARM_STEPS = 3


class Feed:
    """Epoch-shuffled [steps, B] row ids from the seed's host rng, one
    upload an epoch."""

    def __init__(self, n: int, batch: int, seed: int, device):
        self.rng = np.random.default_rng(seed)
        self.n, self.batch, self.device = n, batch, device
        self.epoch_rows = None
        self.pos = 0

    def next(self):
        """(row ids on the device, True when this row ends an epoch)."""
        if self.epoch_rows is None or self.pos == len(self.epoch_rows):
            steps = self.n // self.batch
            perm = self.rng.permutation(self.n)[:steps * self.batch]
            self.host_rows = perm.reshape(steps, self.batch)
            self.epoch_rows = torch.from_numpy(self.host_rows).to(
                self.device)
            self.pos = 0
        row = self.epoch_rows[self.pos]
        self.pos += 1
        return row, self.pos == len(self.epoch_rows)


def cohort(ctx: H.Context):
    kind = ctx.traffic["generator"]
    return getattr(G, kind)(ctx.traffic, ctx.config["DIM"], ctx.seed,
                            ctx.device)


def build(ctx: H.Context, weights: Dict[str, torch.Tensor], x, y):
    """The program's Trainer and DeviceCachedLoop over the cohort, its
    model holding ``weights``."""
    from cmrtpu_torch import config as C
    from cmrtpu_torch.models.hybrids import get_model
    from cmrtpu_torch.train.device_cache import DeviceCachedLoop
    from cmrtpu_torch.train.trainer import Trainer

    ctx.mark("program_imported")
    cfg = C.normalise_config(dict(ctx.config))
    with torch.device(ctx.device):
        model = get_model(cfg)
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise RuntimeError("the program's parameters differ from the "
                           f"reference's: {sorted(names ^ set(weights))}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    trainer = Trainer(cfg, model=model, device=ctx.device)
    cache = SimpleNamespace(_cache_x=x, _cache_y=y, masks=True,
                            images=range(len(x)))
    return trainer, DeviceCachedLoop(trainer, cache)


def _gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number the check reads: the loss's relative gap at step 1 and
    over steps 1-3, and for the first gradient and the three steps'
    change, each leaf's gap of norms over the larger of its reference norm
    and the median leaf's, by the worst leaf and by the median leaf. The
    change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone)."""
    out = {"loss_gap_step1": abs(prog["loss"][0] - ref["loss"][0])
           / abs(ref["loss"][0]),
           "loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(prog["loss"], ref["loss"]))}
    leaves = list(ref["grad"])
    ref = {key: {k: v.cpu() for k, v in ref[key].items()}
           for key in ("grad", "change")} | {"loss": ref["loss"]}
    prog = {key: {k: v.cpu() for k, v in prog[key].items()}
            for key in ("grad", "change")} | {"loss": prog["loss"]}
    norm = {key: {k: float(ref[key][k].norm()) for k in leaves}
            for key in ("grad", "change")}
    g_med = float(np.median(list(norm["grad"].values())))
    moved = [k for k in leaves if norm["grad"][k] >= 1e-3 * g_med]
    for key, ls in (("grad", leaves), ("change", moved)):
        r = norm[key]
        floor = float(np.median([r[k] for k in ls]))
        gaps = [abs(float(prog[key][k].norm()) - r[k]) / max(r[k], floor)
                for k in ls]
        diffs = [float((prog[key][k] - ref[key][k]).norm())
                 / max(r[k], floor) for k in ls]
        out[f"{key}_worst_gap"] = max(gaps)
        out[f"{key}_median_gap"] = float(np.median(gaps))
        out[f"{key}_median_diff"] = float(np.median(diffs))
        out[f"{key}_worst_diff"] = max(diffs)
    return out


def _images_per_step(cfg: Dict) -> int:
    dim = cfg["DIM"]
    return int(cfg["BATCHSIZE"]) * (int(dim[0]) if len(dim) == 3 else 1)


def readings(trainer, loop, rows, weights):
    """Steps 1-3 through the loop's own call: losses, the first gradient
    (as the optimizer got it) and the change over the three steps, leaf by
    leaf, kept on the host."""
    model = trainer.model
    out = {"loss": []}
    for i, ids in enumerate(rows):
        logs = loop.train_step(torch.as_tensor(ids, device=loop.device))
        out["loss"].append(float(logs["loss"]))
        if i == 0:
            out["grad"] = {n: p.grad.detach().float().cpu()
                           for n, p in model.named_parameters()}
    out["change"] = {n: (p.detach().float() - weights[n]).cpu()
                     for n, p in model.named_parameters()}
    return out


def run(ctx: H.Context) -> Dict:
    cfg, dev = ctx.config, ctx.device
    ctx.mark("start")
    x, y = cohort(ctx)
    ctx.mark("cohort")
    weights = make_weights(cfg, ctx.seed, dev)
    trainer, loop = build(ctx, weights, x, y)
    ctx.mark("build")
    for name, fault in ctx.faults.items():
        fault(trainer, loop)
    batch = int(cfg["BATCHSIZE"])
    feed = Feed(len(x), batch, ctx.seed, dev)
    first = [feed.next()[0] for _ in range(CHECK_STEPS)]
    rows = np.stack([r.cpu().numpy() for r in first])
    prog = readings(trainer, loop, rows, weights)
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
        traced = T.profile(lambda: loop.train_step(feed.next()[0]),
                           float(ctx.traffic.get("trace_seconds", 2.0)),
                           ctx.tmp)
    del trainer, loop, epoch_logs
    gc.collect()
    H.empty_cache(dev)

    ref = reference_steps(cfg, ctx.seed, weights, x, y, rows, dev)
    numbers = _gaps(prog, ref)
    checks = H.checks_from(numbers, ctx.limits)

    dim = cfg["DIM"]
    planes = batch * len(cfg["MASK_VALUES"]) * (int(dim[0])
                                                if len(dim) == 3 else 1)
    return {
        "correct": H.passes(checks),
        "attempted": steps, "failed": 0,
        "setup_s": t_window - ctx.t_start,
        "window_s": window_s, "steps": steps,
        "images": steps * _images_per_step(cfg),
        "step_flops": train_step_flops(cfg, batch),
        "k1_call": {"planes": planes, "h": int(dim[-2]), "w": int(dim[-1]),
                    "sigma": float(cfg["SIGMA"])},
        "chips": ctx.chips,
        "memory_peak_bytes": peak,
        "trace": traced,
        "breakdown": traced["breakdown"] if traced else None,
        "device": device_info(ctx, peak, traced),
        "checks": checks,
        "readings": numbers,
        "marks": ctx.marks,
    }


def device_info(ctx: H.Context, peak: int, traced) -> Dict:
    dev = ctx.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": ctx.chips, "memory_peak_bytes": int(peak),
            "power_limit": H.power_limit()}
    if traced:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    return info


def reference_steps(cfg: Dict, seed: int, weights, x, y, rows, dev,
                    quant=None) -> Dict:
    """The reference's first steps over the cohort (as the cache holds it:
    rounded to bfloat16 where the configuration caches in bfloat16) on
    ``rows``, in float32 with TF32 off, or in ``quant``."""
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
        return R.run_steps(cfg, seed, weights, data_x, data_y, rows,
                           quant=quant)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def control(ctx: H.Context) -> Dict[str, float]:
    """Every number the check reads when the reference in a lower
    precision stands in for the program, on the rows a run would train
    first; the check has to reject them."""
    cfg, dev, quant = ctx.config, ctx.device, QUANTS[ctx.control]
    x, y = cohort(ctx)
    weights = make_weights(cfg, ctx.seed, dev)
    feed = Feed(len(x), int(cfg["BATCHSIZE"]), ctx.seed, dev)
    rows = np.stack([feed.next()[0].cpu().numpy()
                     for _ in range(CHECK_STEPS)])
    ref = reference_steps(cfg, ctx.seed, weights, x, y, rows, dev)
    low = reference_steps(cfg, ctx.seed, weights, x, y, rows, dev, quant)
    return _gaps(low, ref)
