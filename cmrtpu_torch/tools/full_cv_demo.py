"""Full cross-validation on an anatomically structured phantom cohort through
cmrtpu_torch — the reference's whole user flow on one CUDA card, no download
needed; counterpart of ``examples/full_cv_demo.py``.

Generates N patients of short-axis-like phantoms (LV blood pool, MYO ring,
RV crescent; labels RV=1 MYO=2 LV=3 like ACDC), derives the two RV
insertion points as the intersections of the RV boundary with the MYO outer
contour, and writes the ACDC-shaped tree:

    original/patientXXX/Info.cfg                      ED/ES frames + pathology
    original/patientXXX/patientXXX_frameYY.nii.gz     CMR phases
    original/patientXXX/patientXXX_frameYY_gt.nii.gz  ventricle masks
    original/patientXXX/patientXXX_4d.nii.gz          2-frame cine
    io/patientXXX_frameYY_rvip.nrrd                   RVIP labels {1,2}

then runs ``cli.make_dataset`` -> training of every fold with the chained
``pred_fold`` -> ``evaluate_cv`` with all four sources and prints the
localisation summary, the wall time of each fold and the card's name and
power limit; ``<exp>/summary.json`` keeps them.

    python -m cmrtpu_torch.tools.full_cv_demo --root /tmp/cv --patients 100 \
        --epochs 150

``--patients 8 --epochs 2 --dim 64 --folds 0 --device cpu`` is a CPU-sized
smoke run. The decoder is the transpose-conv one (``USE_UPSAMPLE: false``),
as cmrtpu's demo trains it; ``--upsample`` selects the flagship's upsample
+ conv decoder. The published arms: Base (``--no-gaus``), Var.1
(``--hist-matching``), Var.2 (σ=2, the default) and Var.3 (``--sigma 4``);
``--bn`` trains BatchNorm instead of GroupNorm 16 and ``--multihead`` adds
a softmax LV/MYO/RV head beside the RVIP head. Flags for what is not ported
raise.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

from cmrtpu_torch.io import MedicalImage, write_image
from cmrtpu_torch.utils.io_utils import ensure_dir

PATHOLOGIES = ["NOR", "MINF", "DCM", "HCM", "RV"]


def _circle_intersections(c1, r1, c2, r2):
    """Intersection points of two circles, (y, x) coords; None if disjoint."""
    c1 = np.asarray(c1, float)
    c2 = np.asarray(c2, float)
    d = float(np.linalg.norm(c2 - c1))
    if d == 0 or d > r1 + r2 or d < abs(r1 - r2):
        return None
    a = (r1 * r1 - r2 * r2 + d * d) / (2 * d)
    h2 = r1 * r1 - a * a
    if h2 < 0:
        return None
    h = np.sqrt(h2)
    u = (c2 - c1) / d
    mid = c1 + a * u
    perp = np.array([-u[1], u[0]])
    return mid + h * perp, mid - h * perp


def _slice_phantom(hw, center, r_lv, t_myo, theta, r_rv, rng):
    """One SAX slice: (image f32, ventricle mask {1,2,3}, (ant_ip, inf_ip))."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
    cy, cx = center
    r1 = r_lv + t_myo                      # MYO outer radius
    rv_dir = np.array([np.sin(theta), -np.cos(theta)])   # RV sits to the left
    rv_c = np.array([cy, cx]) + rv_dir * (r1 + 0.45 * r_rv)

    d_lv = np.hypot(yy - cy, xx - cx)
    d_rv = np.hypot(yy - rv_c[0], xx - rv_c[1])
    msk = np.zeros((hw, hw), np.uint8)
    msk[d_rv <= r_rv] = 1                                   # RV
    msk[(d_lv > r_lv) & (d_lv <= r1)] = 2                   # MYO ring wins
    msk[d_lv <= r_lv] = 3                                   # LV blood pool

    ips = _circle_intersections((cy, cx), r1, rv_c, r_rv)
    if ips is None:
        raise ValueError("phantom RV does not touch the MYO ring")
    # anterior = superior intersection (smaller y), inferior = the other
    ant, inf = sorted(ips, key=lambda p: p[0])

    img = np.full((hw, hw), 120.0)
    img[msk == 1] = 380.0
    img[msk == 2] = 200.0
    img[msk == 3] = 420.0
    from scipy.ndimage import gaussian_filter
    img = gaussian_filter(img, 1.5) + rng.normal(0, 25.0, (hw, hw))
    return img.astype(np.float32), msk, (ant, inf)


def _rvip_mask(hw, ant, inf):
    msk = np.zeros((hw, hw), np.uint8)
    for point, value in ((ant, 1), (inf, 2)):
        y, x = int(round(point[0])), int(round(point[1]))
        msk[max(0, y - 1):y + 2, max(0, x - 1):x + 2] = value
    return msk


def generate_cohort(root, n_patients=100, hw=200, n_slices=8,
                    spacing=1.37, seed=0):
    rng = np.random.default_rng(seed)
    ensure_dir(os.path.join(root, "io"))
    sp3 = (spacing, spacing, 8.0)
    for p in range(1, n_patients + 1):
        pid = f"patient{p:03d}"
        pdir = os.path.join(root, "original", pid)
        ensure_dir(pdir)
        jit = max(1, int(hw * 0.06))
        center = (hw / 2 + rng.integers(-jit, jit + 1),
                  hw / 2 + rng.integers(-jit, jit + 1))
        r_lv0 = hw * rng.uniform(0.11, 0.15)
        t_myo = hw * rng.uniform(0.035, 0.055)
        theta = rng.uniform(-0.5, 0.5)
        pathology = PATHOLOGIES[(p - 1) % len(PATHOLOGIES)]
        frames = {}
        for frame, lv_scale in (("01", 1.0), ("12", 0.72)):   # ED / ES
            imgs, vmsks, rvips = [], [], []
            for z in range(n_slices):
                z_scale = 1.0 - 0.035 * z                      # toward apex
                img, vmsk, (ant, inf) = _slice_phantom(
                    hw, center, r_lv0 * lv_scale * z_scale, t_myo * z_scale,
                    theta + rng.normal(0, 0.03),
                    (r_lv0 * 0.95) * z_scale, rng)
                imgs.append(img)
                vmsks.append(vmsk)
                rvips.append(_rvip_mask(hw, ant, inf))
            frames[frame] = np.stack(imgs)
            write_image(MedicalImage(array=np.stack(imgs), spacing=sp3),
                        os.path.join(pdir, f"{pid}_frame{frame}.nii.gz"))
            write_image(MedicalImage(array=np.stack(vmsks), spacing=sp3),
                        os.path.join(pdir, f"{pid}_frame{frame}_gt.nii.gz"))
            write_image(MedicalImage(array=np.stack(rvips), spacing=sp3),
                        os.path.join(root, "io", f"{pid}_frame{frame}_rvip.nrrd"))
        write_image(MedicalImage(array=np.stack([frames["01"], frames["12"]]),
                                 spacing=sp3 + (1.0,)),
                    os.path.join(pdir, f"{pid}_4d.nii.gz"))
        with open(os.path.join(pdir, "Info.cfg"), "w") as fh:
            fh.write(f"ED: 1\nES: 12\nGroup: {pathology}\n"
                     f"Height: 170.0\nNbFrame: 2\nWeight: 75.0\n")
    print(f"cohort: {n_patients} patients written under {root}/original")


def _write_seg_slices(root):
    """Per-slice ventricle-mask targets for the softmax head: every 2D
    ``_msk.nrrd`` (RVIP) slice gets a ``_seg.nrrd`` sibling cut from the
    patient's ``*_gt.nii.gz`` volume, so the generator's default
    HEAD_MASK_RULES ('msk' -> head name) resolves them directly."""
    import glob
    import re

    from cmrtpu_torch.io import read_image

    two_d = os.path.join(root, "2D")
    pattern = re.compile(r"(patient\d+)__t(\d+)_z(\d+)_msk\.nrrd$")
    vols = {}
    written = 0
    for msk_f in sorted(glob.glob(os.path.join(two_d, "*_msk.nrrd"))):
        m = pattern.search(os.path.basename(msk_f))
        if not m:
            continue
        pid, frame, z = m.group(1), m.group(2), int(m.group(3))
        gt_f = os.path.join(root, "original", pid,
                            f"{pid}_frame{frame}_gt.nii.gz")
        if gt_f not in vols:
            vols[gt_f] = read_image(gt_f)
        gt = vols[gt_f]
        write_image(MedicalImage(array=gt.array[z], spacing=gt.spacing[:2]),
                    msk_f.replace("_msk.nrrd", "_seg.nrrd"))
        written += 1
    print(f"multihead: {written} per-slice _seg targets written")


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _floats(values):
    return np.array([np.nan if v is None else v for v in values], float)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default="/tmp/cmrtpu_torch_cv")
    parser.add_argument("--patients", type=int, default=100)
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--dim", type=int, default=224)
    parser.add_argument("--folds", type=int, nargs="*", default=[0, 1, 2, 3])
    parser.add_argument("--batch", type=int, default=0,
                        help="0 = auto: min(128, one fold's train slices)")
    parser.add_argument("--skip-generate", action="store_true")
    parser.add_argument("--seed", type=int, default=42,
                        help="training seed (cohort generation stays fixed "
                             "so seeds are comparable on identical data)")
    parser.add_argument("--sigma", type=float, default=2,
                        help="Gaussian GT-heatmap sigma (Var.2=2, Var.3=4)")
    parser.add_argument("--no-gaus", action="store_true",
                        help="binary GT targets (the published Base arm)")
    parser.add_argument("--group-norm", type=int, default=16,
                        help="GroupNorm group count")
    parser.add_argument("--bn", action="store_true",
                        help="BatchNorm instead of the GROUP_NORM=16 "
                             "default (the reference-parity arm)")
    parser.add_argument("--upsample", action="store_true",
                        help="the flagship's upsample + conv decoder "
                             "(USE_UPSAMPLE) instead of the transpose conv")
    parser.add_argument("--hist-matching", action="store_true",
                        help="the Var.1 histogram-matching arm")
    parser.add_argument("--multihead", action="store_true",
                        help="RVIP sigmoid head + LV/MYO/RV softmax head "
                             "(per-slice _seg targets are cut from the "
                             "cohort's ventricle gt volumes)")
    parser.add_argument("--head-prior", type=float, default=None,
                        help="initialise sigmoid-head biases to this "
                             "foreground prior's logit (HEAD_BIAS_PRIOR)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VAL",
                        help="override any config key (VAL is JSON-parsed "
                             "when possible)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    parser.add_argument("--budget-s", type=float, default=None,
                        help="start no further fold once the run so far "
                             "plus its slowest fold would pass this many "
                             "seconds (fold 0 always runs)")
    parser.add_argument("--cache-dtype", default="float32",
                        help="device-cache storage dtype: float32 | bfloat16 "
                             "| uint8 (per-example affine quantization)")
    parser.add_argument("--agc", type=float, default=None,
                        help="adaptive gradient clipping factor (AGC, e.g. "
                             "0.08)")
    parser.add_argument("--cache-sharded", action="store_true",
                        help="the sharded device cache (CACHE_SHARDED) on "
                             "its one shard (ROADMAP 6.0)")
    parser.add_argument("--ws", action="store_true",
                        help="normalization-free scaled-WS convs instead of "
                             "BatchNorm (WEIGHT_STANDARDISATION; "
                             "EXPERIMENTAL: collapses at flagship scale)")
    args = parser.parse_args(argv)

    from cmrtpu_torch import config as C
    from cmrtpu_torch.cli.make_dataset import main as make_dataset_main
    from cmrtpu_torch.eval.evaluate import evaluate_cv
    from cmrtpu_torch.train.fold import run_experiment

    # a fold trains on ~3/4 of the patients x 2 phases x 8 slices; the batch
    # must not exceed that or the cached loop has zero batches per epoch
    n_train_slices = max(1, (args.patients * 3 // 4)) * 2 * 8
    batch = args.batch or min(128, n_train_slices)

    t0 = time.perf_counter()
    if not args.skip_generate:
        hw = max(64, int(args.dim * 200 / 224))
        generate_cohort(args.root, n_patients=args.patients, hw=hw)
    if not os.path.isdir(os.path.join(args.root, "2D")):
        make_dataset_main(args.root, os.path.join(args.root, "original"))
    if args.multihead:
        _write_seg_slices(args.root)
    data_s = time.perf_counter() - t0

    config = {
        "EXPERIMENT": "full_cv",
        "EXPERIMENTS_ROOT": os.path.join(args.root, "exp/"),
        "SEED": args.seed, "EPOCHS": args.epochs, "BATCHSIZE": batch,
        "DIM": [args.dim, args.dim], "SPACING": [1.2, 1.2], "RESAMPLE": True,
        "DEPTH": 4, "FILTERS": 32, "M_POOL": [2, 2], "F_SIZE": [3, 3],
        "MASK_VALUES": [1, 2], "MASK_CLASSES": 2, "OPTIMIZER": "adam",
        "LEARNING_RATE": 1e-3, "LOSS_FUNCTION": "BceDiceLoss",
        "MIXED_PRECISION": True, "USE_UPSAMPLE": args.upsample,
        "AUGMENT": True, "AUGMENT_PROB": 0.8, "RANDOMROTATE": True,
        "SHIFTSCALEROTATE": True, "GRIDDISTORTION": True,
        "GAUS": not args.no_gaus, "SIGMA": args.sigma,
        "HIST_MATCHING": args.hist_matching, "SCALER": "MinMax",
        "CC_FILTER": True,
        "EARLY_STOPPING_PATIENCE": args.epochs,
        # checkpoints selected on the mean landmark error in mm
        "MONITOR_LOCALISATION": True,
        "MONITOR_FUNCTION": "val_loss",
        "SAVE_MODEL_FUNCTION": "val_loc_mm", "SAVE_MODEL_MODE": "min",
        "WEIGHT_STANDARDISATION": args.ws,
        "WS_I_UNDERSTAND": args.ws,  # the explicit --ws flag is the ack
        "BATCH_NORMALISATION": not args.ws,
        "GROUP_NORM": 0 if (args.bn or args.ws) else args.group_norm,
        "HEAD_BIAS_PRIOR": args.head_prior,
        "CACHE_DTYPE": args.cache_dtype, "CACHE_SHARDED": args.cache_sharded,
        "AGC": args.agc,
    }
    config.update(C.parse_override_pairs(args.set))
    if args.multihead:
        # the first sigmoid head keeps the _msk landmark contract; the
        # softmax head (labels RV=1 MYO=2 LV=3 and background) adds the
        # per-structure seg dice columns
        config["HEADS"] = [["rvip", 2, "sigmoid"], ["seg", 4, "softmax"]]
        # the live loc_mm metric covers single-head models only (the
        # Trainer raises otherwise, in cmrtpu too): select on val_loss
        config.update(MONITOR_LOCALISATION=False,
                      SAVE_MODEL_FUNCTION="val_loss")
    exp_path = C.timestamped_exp_path(config)
    fold_s = {}
    for fold in args.folds:
        if fold_s and args.budget_s is not None and time.perf_counter() - t0 \
                + max(fold_s.values()) > args.budget_s:
            print(f"folds {args.folds[len(fold_s):]} skipped: --budget-s "
                  f"{args.budget_s:g}", flush=True)
            break
        t = time.perf_counter()
        run_experiment(dict(config, FOLDS=[fold]), data_path=args.root,
                       exp_path=exp_path, device=args.device)
        fold_s[fold] = time.perf_counter() - t
        print(f"fold {fold}: {fold_s[fold]:.1f} s (train + pred_fold)",
              flush=True)

    t = time.perf_counter()
    df = evaluate_cv(exp_path, args.root)
    eval_s = time.perf_counter() - t
    print(f"\ndf_eval: {len(df['patient'])} patient-phase rows x {len(df)} "
          "columns")
    print(f"sources present: io={'files_io' in df}, "
          f"orig ventricle masks={'files_orig_msk' in df}")
    print("\n=== localisation summary (mm) ===")
    summary = {"rows": len(df["patient"]), "columns": len(df),
               "folds": list(fold_s), "fold_wall_s": fold_s,
               "data_s": data_s, "evaluate_s": eval_s, "device": args.device,
               "decoder": "upsample" if args.upsample else "transpose",
               "card": _card() if args.device.startswith("cuda") else None}
    for c in ("mdists_ant_gtpred", "mdists_inf_gtpred",
              "mdists_ant_gtio", "mdists_inf_gtio",
              "mdists_ant_gtorig", "mdists_inf_gtorig",
              "tpr_ant_point_th15", "ppv_ant_point_th15",
              "tpr_inf_point_th15", "ppv_inf_point_th15",
              "seg_dice_rv", "seg_dice_myo", "seg_dice_lv"):
        if c in df:
            vals = _floats(df[c])
            mean = float(np.nanmean(vals))
            print(f"  {c:28s} {mean:8.3f} +- {np.nanstd(vals, ddof=1):.3f}")
            summary[c] = mean
    out = os.path.join(exp_path, "df_eval.csv")
    print(f"\nfull table: {out}")
    print(f"card: {summary['card']}")
    with open(os.path.join(exp_path, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
