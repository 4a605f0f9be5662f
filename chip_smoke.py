#!/usr/bin/env python3
"""Smoke run of cmrtpu_torch on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each:
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile csrc/cc_labels.cu with nvcc, print ptxas's report;
  3. k2      — the CC-label kernel against its plain torch version on the
               card and scipy's labels, exact, at [10, 224, 224];
  4. forward — the flagship U-Net (exp/template_cfgs/gaus_sigma2_config.json)
               with seeded random weights at batch 16, bf16 on the card,
               against the port's f32 forward on the CPU;
  5. serve   — a fold with those weights serves 3 synthetic studies through
               the cmrtpu_torch.cli.serve entry point; the kernel's launch
               counter must show the main path went through it.
Then one JSON line of kernel figures and, last, the result line
``{"ok": true, "device": {...}}``. Any failed check raises, which exits
non-zero without a result line; so does a host without CUDA. Imports
nothing of JAX.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

# the shared cmrtpu host modules import jax when this is set
os.environ.pop("CMRTPU_PLATFORM", None)

import numpy as np  # noqa: E402
import scipy.ndimage  # noqa: E402
import torch  # noqa: E402

from cmrtpu_torch.cli.serve import main as serve_main  # noqa: E402
from cmrtpu_torch.io import MedicalImage, read_image, write_image  # noqa: E402
from cmrtpu_torch.models.unet import build_model  # noqa: E402
from cmrtpu_torch.ops import connected_components as cc  # noqa: E402
from cmrtpu_torch.ops import cuda_kernels as kernels  # noqa: E402
from cmrtpu_torch.train.checkpoint import save_weights  # noqa: E402

SEED = 0
FLAGSHIP = os.path.join("exp", "template_cfgs", "gaus_sigma2_config.json")
Z, H, W = 10, 224, 224
INF = 2 ** 30
# card f32 (TF32 off) against CPU f32: the same math summed in another
# order, so a tight bound on probabilities
F32_ATOL = 1e-3
# card bf16 against CPU f32: bf16 keeps ~3 significant digits through 19
# conv + GroupNorm layers. On the CPU at 32^2 the reference's own bf16 output
# lies up to 0.17 from its f32 output. Measured on an H100 (700 W): max
# 0.149, mean 0.0131. A bf16 forward passes only if it is within both bounds;
# the control forwards below (a constant 0.5 output, and the net with one
# GroupNorm skipped) must each fail one of them, or the run fails. Measured
# on an H100 (700 W), the controls lie at max 0.385 and mean 0.095 or more
BF16_MAX_ATOL, BF16_MEAN_ATOL = 0.25, 0.025


def log(phase, **fields):
    print(f"[{phase}] {json.dumps(fields)}", flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean time of ``fn`` on the card over ``reps`` runs after one warm
    run, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scipy_min_index_labels(masks):
    """scipy 4-connected labels, each component renamed to its min index."""
    out = np.full(masks.shape, INF, np.int32)
    for i, m in enumerate(masks):
        lab, n = scipy.ndimage.label(m)
        first = np.full(n + 1, INF, np.int64)
        np.minimum.at(first, lab.ravel(), np.arange(lab.size))
        out[i] = np.where(lab > 0, first[lab], INF)
    return out


def kept_reference(labels):
    """Largest component per slice from min-index labels (numpy): ties go to
    the smallest id, empty slices stay empty."""
    kept = np.zeros(labels.shape, bool)
    for i, lab in enumerate(labels):
        ids, counts = np.unique(lab[lab < INF], return_counts=True)
        if ids.size:
            kept[i] = lab == ids[np.argmax(counts)]
    return kept


def k2_cases():
    rng = np.random.default_rng(SEED)
    cases = {f"random-{d}": rng.random((Z, H, W)) < d
             for d in (0.3, 0.55, 0.7)}
    serp = np.zeros((H, W), bool)
    for r in range(0, H, 2):  # boustrophedon corridor: longest geodesic
        serp[r, :] = True
        if r + 1 < H:
            serp[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    cases["serpentine"] = np.repeat(serp[None], Z, axis=0)
    edge = np.zeros((Z, H, W), bool)
    edge[1::3] = True                      # full slices
    edge[2, 0, 0] = edge[5, H - 1, W - 1] = edge[8, H // 2, W // 3] = True
    cases["empty-full-single"] = edge      # the rest stay empty
    return cases


def phase_k2():
    """Exact equality of the kernel with the plain version and scipy."""
    results, max_err = {}, 0
    for name, masks in k2_cases().items():
        dev = torch.from_numpy(masks).cuda()
        got = kernels.converge_labels_cuda(dev)
        plain = cc.label_components_2d(dev)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"k2 {name}: kernel != plain (max abs {err})")
        want = scipy_min_index_labels(masks)
        check(np.array_equal(got.cpu().numpy(), want),
              f"k2 {name}: kernel != scipy")
        check(np.array_equal(cc.largest_component_batch(dev).cpu().numpy(),
                             kept_reference(want)),
              f"k2 {name}: kept masks on the card != scipy's")
        slow = name == "serpentine"
        ms = cuda_ms(lambda: kernels.converge_labels_cuda(dev), 5 if slow else 50)
        plain_ms = cuda_ms(lambda: cc.label_components_2d(dev), 2 if slow else 10)
        results[name] = {"ms": ms, "plain_ms": plain_ms}
        log("k2", case=name, shape=list(masks.shape), exact=True, ms=ms,
            plain_ms=plain_ms)
    return results, max_err


def _errors(out, ref):
    return {"max": float(np.abs(out - ref).max()),
            "mean": float(np.abs(out - ref).mean())}


def _without_norm(model, block):
    """A copy of ``model`` whose ConvBlock ``block`` skips its norm."""
    control = copy.deepcopy(model)
    control.get_submodule(block).norm_name = None
    return control


def phase_forward(cfg):
    """Flagship forward: card bf16 and card f32 against the CPU, and
    control forwards that the bf16 bounds must reject."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).eval()
    f32_cfg = dict(cfg, MIXED_PRECISION=False)
    cpu = build_model(f32_cfg).eval()
    cpu.load_state_dict(model.state_dict())
    card_f32 = build_model(f32_cfg).eval()
    card_f32.load_state_dict(model.state_dict())
    batch = int(cfg["BATCHSIZE"])
    x = np.random.default_rng(SEED).standard_normal(
        (batch, H, W, 1)).astype(np.float32)
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x)).numpy()
        xd = torch.from_numpy(x).cuda()
        model.cuda()
        card_f32.cuda()
        bf16 = model(xd).cpu().numpy()
        f32 = card_f32(xd).cpu().numpy()
        ms = cuda_ms(lambda: model(xd), 20)
        ms_f32 = cuda_ms(lambda: card_f32(xd), 20)
        controls = {"constant_0.5": _errors(np.full_like(ref, 0.5), ref)}
        for block in ("ConvBlock_1", f"UpBlock_{model.depth - 1}.ConvBlock_1"):
            out = _without_norm(model, block)(xd).cpu().numpy()
            controls[f"no_norm_{block}"] = _errors(out, ref)
    check(np.isfinite(bf16).all() and bf16.shape == (batch, H, W, 2),
          f"forward: bad output {bf16.shape}")
    f32_err, bf16_err = _errors(f32, ref), _errors(bf16, ref)
    bounds = {"f32_max": F32_ATOL, "bf16_max": BF16_MAX_ATOL,
              "bf16_mean": BF16_MEAN_ATOL}
    log("forward", batch=batch, dtype="bfloat16", ms=ms, f32_ms=ms_f32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        f32_vs_cpu_f32=f32_err, bf16_vs_cpu_f32=bf16_err,
        controls_vs_cpu_f32=controls, bounds=bounds)
    check(f32_err["max"] <= F32_ATOL,
          f"forward: card f32 max {f32_err['max']} > {F32_ATOL}")
    check(bf16_err["max"] <= BF16_MAX_ATOL
          and bf16_err["mean"] <= BF16_MEAN_ATOL,
          f"forward: card bf16 {bf16_err} outside the bounds {bounds}")
    for name, err in controls.items():
        check(err["max"] > BF16_MAX_ATOL or err["mean"] > BF16_MEAN_ATOL,
              f"forward: control {name} {err} passes the bf16 bounds, which "
              "therefore cannot tell a wrong forward from bf16 rounding")
    return model.cpu()


def _phantom(rng, z, ny, nx):
    """Short-axis-like stack: a bright blood pool and a myocardial ring on
    noise, drifting across slices."""
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float32)
    vol = rng.normal(200.0, 40.0, (z, ny, nx)).astype(np.float32)
    for k in range(z):
        cy, cx = ny / 2 + 3 * np.sin(k), nx / 2 + 3 * np.cos(k)
        r = np.hypot(yy - cy, xx - cx)
        vol[k] += 600.0 * (r < 18 + k) + 300.0 * ((r > 24 + k) & (r < 32 + k))
    return vol


def phase_serve(cfg, model):
    """Serve synthetic studies through the CLI entry point."""
    rng = np.random.default_rng(SEED)
    studies = {"study0.nrrd": (0.0, 0.0, 0.0),
               "study1.nii.gz": (-120.5, 80.25, 30.0),
               "study2.nrrd": (12.0, -7.5, -45.0)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        fold = os.path.join(work, "fold")
        os.makedirs(os.path.join(fold, "config"))
        with open(os.path.join(fold, "config", "config.json"), "w") as fh:
            json.dump(cfg, fh)
        save_weights(os.path.join(fold, "model"), model)
        in_dir, out_dir = os.path.join(work, "in"), os.path.join(work, "out")
        os.makedirs(in_dir)
        for name, origin in studies.items():
            path = os.path.join(in_dir, name)
            write_image(MedicalImage(array=_phantom(rng, Z, 216, 256),
                                     spacing=(1.5625, 1.5625, 10.0),
                                     origin=origin), path)
            os.utime(path, (0, 0))  # settled

        kernels.converge_labels_cuda.launches = 0
        t0 = time.perf_counter()
        totals = serve_main(["-exp", fold, "-in", in_dir, "-out", out_dir,
                             "--max-studies", str(len(studies))])
        wall_s = time.perf_counter() - t0
        launches = kernels.converge_labels_cuda.launches

        check(totals["studies"] == len(studies), f"serve: totals {totals}")
        latencies = {}
        for name, origin in studies.items():
            stem = name.split(".")[0]
            with open(os.path.join(out_dir, f"{stem}.done.json")) as fh:
                record = json.load(fh)
            check("error" not in record, f"serve {name}: {record}")
            pred = read_image(os.path.join(out_dir, f"{stem}_msk_pred.nrrd"))
            check(pred.array.shape == (Z, 216, 256),
                  f"serve {name}: shape {pred.array.shape}")
            check(np.allclose(pred.spacing, (1.5625, 1.5625, 10.0)),
                  f"serve {name}: spacing {pred.spacing}")
            check(np.allclose(pred.origin, origin),
                  f"serve {name}: origin {pred.origin}")
            check(set(np.unique(pred.array)) <= {0, 1, 2},
                  f"serve {name}: labels {np.unique(pred.array)}")
            latencies[name] = {k: record[k] for k in
                               ("read_s", "preprocess_s", "forward_s",
                                "post_write_s", "total_s", "slices")}
    # one launch per label value per study, plus the engine's warm-up
    check(launches >= 2 * len(studies),
          f"serve: {launches} kernel launches for {len(studies)} studies")
    check("jax" not in sys.modules, "serve: jax was imported")
    log("serve", studies=len(studies), launches=launches, wall_s=wall_s,
        totals=totals, latencies=latencies)
    return launches


def main():
    check("jax" not in sys.modules, "importing the port imported jax")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    ptxas = kernels.build()
    log("build", seconds=time.perf_counter() - t0,
        ptxas=[line.strip() for line in ptxas.splitlines()
               if "registers" in line or "spill" in line or "smem" in line])

    k2, max_err = phase_k2()

    with open(FLAGSHIP, encoding="utf-8") as fh:
        cfg = json.load(fh)
    model = phase_forward(cfg)
    launches = phase_serve(cfg, model)

    headline = k2["random-0.55"]
    print(json.dumps({"kernels": [{
        "name": "converge_labels_cuda", "route": "cuda",
        "source": "cmrtpu_torch/csrc/cc_labels.cu",
        "replaces": "cmrtpu/ops/pallas_kernels.py:148",
        "launches": launches, "max_abs_err": max_err,
        "ms": headline["ms"], "plain_ms": headline["plain_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
