"""Driver of ``cmrtpu_torch.predict.serving.ServingEngine.process_study``:
one worker draining a backlog of studies in a closed loop, as
``serve_directory`` drains a directory.

Set-up makes the studies from the seed and writes them as .nii.gz under
the run's scratch directory, makes the seeded weights, saves them as a
fold (``model.npz``, the program's own writer) and restores the engine
from it, which warms the forward and the CC filter up. A study of each
slice count is served once more before the window. The window serves the
studies one after the other in a seeded order, cycling, each cycle's
outputs overwriting the last, and times each call on the host clock.

Compared (``limits/<cell>.json``), after the window and with the engine
freed, on a sample of the finished studies drawn from the seed (the one
with the most slices always in it), each against the reference's
float32 serving of the same study: see ``compare``.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness as H
from benchmark import trace as T
from benchmark.counts.unet import forward_flops
from benchmark.drivers.train import device_info
from benchmark.reference import files as Fi
from benchmark.reference import serve as R
from benchmark.reference.unet import QUANTS
from benchmark.traffic import generator as G
from benchmark.weights import make_weights

# logit margins: a label written where the reference says no by more
# than TAU is wrong; a voxel of margin over SURE is surely labelled
TAU = 0.5
SURE = 4.0


def write_studies(studies: List[Dict], in_dir: str) -> List[str]:
    os.makedirs(in_dir, exist_ok=True)
    paths = []
    for i, s in enumerate(studies):
        path = os.path.join(in_dir, f"study{i:03d}.nii.gz")
        with open(path, "wb") as fh:
            fh.write(Fi.nifti_bytes(s["array"], s["spacing"], s["origin"]))
        paths.append(path)
    return paths


def build(ctx: H.Context, weights: Dict[str, torch.Tensor]):
    """The program's engine restored from a fold saved with ``weights``."""
    from cmrtpu_torch import config as C
    from cmrtpu_torch.models.hybrids import get_model
    from cmrtpu_torch.predict.serving import ServingEngine
    from cmrtpu_torch.train.checkpoint import save_weights

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
    fold = os.path.join(ctx.tmp, "fold", "model")
    save_weights(fold, model)
    del model
    return ServingEngine(config=cfg, model_path=fold, device=ctx.device)


def run(ctx: H.Context) -> Dict:
    cfg, dev, tr = ctx.config, ctx.device, ctx.traffic
    ctx.mark("start")
    studies = G.studies(tr, ctx.seed, dev)
    paths = write_studies(studies, os.path.join(ctx.tmp, "in"))
    ctx.mark("studies")
    out_dir = os.path.join(ctx.tmp, "out")
    os.makedirs(out_dir)
    weights = make_weights(cfg, ctx.seed, dev,
                           head_bias_prob=tr.get("head_bias_prob"))
    engine = build(ctx, weights)
    ctx.mark("engine")
    for name, fault in ctx.faults.items():
        fault(engine)
    seen = {}
    for i, s in enumerate(studies):  # one study of each slice count
        seen.setdefault(s["array"].shape[0], i)
    for i in seen.values():
        engine.process_study(paths[i], out_dir)
    ctx.mark("warm_studies")
    rng = np.random.default_rng(ctx.seed)
    order = rng.permutation(len(paths))

    H.reset_peak(dev)
    t_window = time.time()
    t0 = time.perf_counter()
    done, lat, records, failed = [], [], [], 0
    k = 0
    while True:
        i = int(order[k % len(order)])
        k += 1
        t = time.perf_counter()
        try:
            rec = engine.process_study(paths[i], out_dir)
        except Exception as e:  # a failed study counts as missing
            failed += 1
            lat.append(float("inf"))
            print(f"study {i} failed: {type(e).__name__}: {e}")
        else:
            lat.append(time.perf_counter() - t)
            records.append(rec)
            done.append(i)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    H.sync(dev)
    window_s = time.perf_counter() - t0
    peak = H.peak_bytes(dev)

    traced, traced_slices = None, []
    if ctx.trace:
        it = iter(order.tolist() * 100)

        def step():
            i = next(it)
            traced_slices.append(studies[i]["array"].shape[0])
            engine.process_study(paths[i], out_dir)

        traced = T.profile(step, float(tr.get("trace_seconds", 2.0)),
                           ctx.tmp)
    del engine
    gc.collect()
    H.empty_cache(dev)

    finished = sorted(set(done))
    n_sample = min(int(tr["sample"]), len(finished))
    longest = max(finished, key=lambda i: studies[i]["array"].size)
    rest = [i for i in finished if i != longest]
    sample = [longest] + list(rng.choice(rest, n_sample - 1, replace=False))
    numbers = compare(cfg, weights, studies, sample, out_dir, dev)
    checks = H.checks_from(numbers, ctx.limits)
    return {
        "correct": failed == 0 and H.passes(checks),
        "attempted": len(lat), "failed": failed,
        "setup_s": t_window - ctx.t_start,
        "window_s": window_s,
        "latencies_s": lat, "records": records,
        "slices": [studies[i]["array"].shape[0] for i in done],
        "forward_flops_per_slice": forward_flops(cfg, 1),
        "traced_k2_calls": [{"planes": 2 * z, "h": int(cfg["DIM"][0]),
                             "w": int(cfg["DIM"][1])}
                            for z in traced_slices],
        "chips": ctx.chips,
        "memory_peak_bytes": peak,
        "trace": traced,
        "breakdown": traced["breakdown"] if traced else None,
        "device": device_info(ctx, peak, traced),
        "checks": checks,
        "readings": numbers,
        "marks": ctx.marks,
    }


def count_components(mask: torch.Tensor) -> int:
    """The 4-connected components of each [y, x] plane of ``mask`` [z, y,
    x] (bool), counted together: min-label propagation with pointer
    jumping, each component labelled by its first voxel."""
    n = mask.numel()
    flat_mask = mask.reshape(-1)
    idx = torch.arange(n, device=mask.device)
    lab = torch.where(mask, idx.reshape(mask.shape), n)
    while True:
        new = lab.clone()
        new[:, 1:] = torch.minimum(new[:, 1:], lab[:, :-1])
        new[:, :-1] = torch.minimum(new[:, :-1], lab[:, 1:])
        new[:, :, 1:] = torch.minimum(new[:, :, 1:], lab[:, :, :-1])
        new[:, :, :-1] = torch.minimum(new[:, :, :-1], lab[:, :, 1:])
        flat = torch.where(flat_mask, new.reshape(-1), n)
        flat = torch.minimum(flat, torch.where(
            flat_mask, flat[flat.clamp(max=n - 1)], n))
        new = flat.reshape(mask.shape)
        if torch.equal(new, lab):
            return int((flat == idx).sum())
        lab = new


def margins(z: np.ndarray) -> np.ndarray:
    """[C, ...] logits -> [C, ...] margin of each label L = c + 1: how far
    the voxel lies inside label L's decision (the channel above 0, every
    later channel, which would overwrite it, not), negative outside."""
    out = np.empty_like(z)
    later = np.full(z.shape[1:], np.inf, z.dtype)
    for c in range(z.shape[0] - 1, -1, -1):
        out[c] = np.minimum(z[c], later)
        later = np.minimum(later, -z[c])
    return out


def compare(cfg: Dict, weights, studies, sample, out_dir: str, dev,
            outputs=None) -> Dict[str, float]:
    """The sample's written label maps (or ``outputs`` {i: label map}) held
    to the reference's float32 serving, TF32 off for the reference:
      fp_share           of the voxels the program labelled, the share that
                         the reference puts outside that label by a margin
                         of more than TAU in logits (precision moves
                         decisions near the threshold only);
      cc_component_gap   the gap between the number of 4-connected
                         components (per slice and label, summed over the
                         sample) in the program's written map and in the
                         reference's CC-filtered one, over the latter: a CC
                         filter that keeps what the reference's drops, or
                         keeps another component, moves it (the unfiltered
                         map holds about 4 times the components; one
                         component a slice in model space comes back in
                         pieces from the nearest resampling);
      empty_slices       slices the program left empty of a label that the
                         reference marks there surely (margin over SURE);
      geometry_mismatch  studies written on another grid, spacing, origin
                         or direction;
      missing            sampled studies with no output.
    The last three are exact: a sound run reads 0."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outside, labelled, comps_got, comps_want = 0, 0, 0, 0
    out = dict(empty_slices=0.0, geometry_mismatch=0.0, missing=0.0)
    try:
        for i in sample:
            s = studies[i]
            want, z = R.serve_study(cfg, weights, s["array"], s["spacing"],
                                    device=dev)
            if outputs is not None:
                got = {"array": outputs[i], "spacing": Fi.f32(s["spacing"]),
                       "origin": Fi.f32(s["origin"]),
                       "direction": np.eye(3)}
            else:
                path = os.path.join(out_dir, f"study{i:03d}_msk_pred.nrrd")
                if not os.path.exists(path):
                    out["missing"] += 1
                    continue
                got = Fi.read_nrrd(path)
            if not (got["array"].shape == z.shape[1:]
                    and got["spacing"] == Fi.f32(s["spacing"])
                    and got["origin"] == Fi.f32(s["origin"])
                    and np.array_equal(got["direction"], np.eye(3))):
                out["geometry_mismatch"] += 1
                continue
            m = margins(z)
            got_t = torch.as_tensor(got["array"], device=dev)
            want_t = torch.as_tensor(want, device=dev)
            for c in range(m.shape[0]):
                wrote = got["array"] == c + 1
                outside += int((m[c][wrote] < -TAU).sum())
                labelled += int(wrote.sum())
                comps_got += count_components(got_t == c + 1)
                comps_want += count_components(want_t == c + 1)
                sure = (m[c] > SURE).any(axis=(1, 2))
                out["empty_slices"] += float(
                    (sure & ~wrote.any(axis=(1, 2))).sum())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return {"fp_share": outside / max(labelled, 1),
            "cc_component_gap": abs(comps_got - comps_want)
            / max(comps_want, 1), **out}


def control(ctx: H.Context) -> Dict[str, float]:
    """Every number the check reads when the reference in a lower
    precision stands in for the program, on a sample drawn as a run draws
    it from all the studies; the check has to reject them."""
    cfg, dev, tr = ctx.config, ctx.device, ctx.traffic
    quant = QUANTS[ctx.control]
    studies = G.studies(tr, ctx.seed, dev)
    weights = make_weights(cfg, ctx.seed, dev,
                           head_bias_prob=tr.get("head_bias_prob"))
    rng = np.random.default_rng(ctx.seed)
    rng.permutation(len(studies))
    longest = max(range(len(studies)), key=lambda i: studies[i]["array"].size)
    rest = [i for i in range(len(studies)) if i != longest]
    sample = [longest] + list(rng.choice(rest, int(tr["sample"]) - 1,
                                         replace=False))
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outputs = {i: R.serve_study(cfg, weights, studies[i]["array"],
                                    studies[i]["spacing"], quant=quant,
                                    device=dev)[0] for i in sample}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return compare(cfg, weights, studies, sample, "", dev, outputs=outputs)
