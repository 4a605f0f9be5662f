"""End-to-end quickstart on synthetic data — counterpart of
``examples/synthetic_quickstart.py``; no ACDC download needed.

Generates a synthetic SAX-like RVIP dataset (per-patient insertion-point
positions, visible image cues), builds the k-fold table, trains one fold
through ``run_experiment`` on ``--device``, runs the chained inference and
the evaluation, and prints the mm localisation errors (mean ± sample SD
over patient-phases); with ``--tta`` and ``--int8`` also the rot90-TTA and
int8 twins of the same fold.

The defaults train the GAUS sigma=2 heatmap variant (Var.2 of the
published experiments), which converges in ~250 epochs. On an NVIDIA H100
80GB HBM3 at 700 W the defaults with --tta --int8 took 61.6-81.4 s
(PERF.md §6):

    python -m cmrtpu_torch.tools.synthetic_quickstart \\
        --root /tmp/cmrtpu_quickstart --epochs 250 --patients 10 --tta --int8
"""

import argparse
import glob
import math
import os
import time

import numpy as np

QUICK_COLS = ("mdists_ant_gtpred", "mdists_inf_gtpred",
              "tpr_ant_point_th15", "ppv_ant_point_th15")


def generate_dataset(root: str, n_patients: int = 10, hw: int = 64,
                     n_slices: int = 8, seed: int = 0) -> None:
    """``root/2D`` slices (two frames of ``n_slices`` slices per patient)
    and ``root/df_kfold.csv`` (4 folds), the files cmrtpu's quickstart
    writes from the same seed."""
    from cmrtpu_torch.data.dataset import get_kfolded_data, write_kfold_csv
    from cmrtpu_torch.io import MedicalImage, write_image
    from cmrtpu_torch.utils.io_utils import ensure_dir

    rng = np.random.default_rng(seed)
    ensure_dir(os.path.join(root, "2D"))
    for p in range(n_patients):
        pid = f"patient{p + 1:03d}"
        ant = np.array([hw // 3 + rng.integers(-4, 5),
                        2 * hw // 3 + rng.integers(-4, 5)])
        inf = np.array([2 * hw // 3 + rng.integers(-4, 5),
                        hw // 3 + rng.integers(-4, 5)])
        for frame in ("01", "12"):
            for z in range(n_slices):
                yy, xx = np.mgrid[0:hw, 0:hw]
                a = ant + rng.integers(-1, 2, 2)
                i = inf + rng.integers(-1, 2, 2)
                img = (2.0 * np.exp(-((yy - a[0]) ** 2 + (xx - a[1]) ** 2) / 18.0)
                       - 2.0 * np.exp(-((yy - i[0]) ** 2 + (xx - i[1]) ** 2) / 18.0)
                       + np.exp(-((yy - hw / 2) ** 2 + (xx - hw / 2) ** 2) / 400.0)
                       + rng.normal(0, 0.15, (hw, hw)))
                msk = np.zeros((hw, hw), np.uint8)
                msk[a[0] - 1:a[0] + 2, a[1] - 1:a[1] + 2] = 1
                msk[i[0] - 1:i[0] + 2, i[1] - 1:i[1] + 2] = 2
                stem = f"{pid}__t{frame}_z{z}"
                write_image(MedicalImage(array=img.astype(np.float32),
                                         spacing=(1.4, 1.4)),
                            os.path.join(root, "2D", f"{stem}_img.nrrd"))
                write_image(MedicalImage(array=msk, spacing=(1.4, 1.4)),
                            os.path.join(root, "2D", f"{stem}_msk.nrrd"))
    rows = get_kfolded_data(kfolds=4, path_to_data=os.path.join(root, "2D"))
    write_kfold_csv(rows, os.path.join(root, "df_kfold.csv"))
    print(f"dataset: {len({r['patient'] for r in rows})} patients, "
          f"{len(rows) // 4} slices")


def quickstart_config(root: str, epochs: int, dim: int,
                      cache_dtype: str = "float32", ema: bool = False,
                      ws: bool = False) -> dict:
    """The experiment config cmrtpu's quickstart trains; ``ws`` is its
    --ws arm (scaled weight-standardised convs, acknowledged, no
    BatchNorm)."""
    return {
        "EXPERIMENT": "quickstart",
        "EXPERIMENTS_ROOT": os.path.join(root, "exp/"),
        "SEED": 42, "EPOCHS": epochs, "BATCHSIZE": 32, "FOLDS": [0],
        "DIM": [dim, dim], "SPACING": [1.4, 1.4], "RESAMPLE": True,
        "DEPTH": 3, "FILTERS": 16, "M_POOL": [2, 2], "F_SIZE": [3, 3],
        "MASK_VALUES": [1, 2], "MASK_CLASSES": 2, "OPTIMIZER": "adam",
        "LEARNING_RATE": 1e-3, "LOSS_FUNCTION": "BceDiceLoss",
        "AUGMENT": True, "AUGMENT_PROB": 0.8, "SHIFTSCALEROTATE": True,
        "GRIDDISTORTION": True, "SCALER": "MinMax", "CC_FILTER": True,
        "USE_UPSAMPLE": False, "EARLY_STOPPING_PATIENCE": epochs,
        "MONITOR_FUNCTION": "val_loss", "SAVE_MODEL_FUNCTION": "val_loss",
        "GAUS": True, "SIGMA": 2,  # Var.2 heatmap targets: fast convergence
        "CACHE_DTYPE": cache_dtype,
        "WEIGHT_STANDARDISATION": ws,
        "WS_I_UNDERSTAND": ws,  # the explicit --ws flag is the ack
        "BATCH_NORMALISATION": not ws,
        "EMA": ema,
    }


def main(argv=None) -> dict:
    """Run the quickstart; returns {"exp": run dir, "df_eval": path,
    "means": {col: mean}, "sd": {col: sample SD}, "tta": ..., "int8": ...
    (the twins' ``report_ab`` dicts, or None), "wall_s": {stage: s}}; the
    wall seconds by stage are printed last."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default="/tmp/cmrtpu_quickstart")
    parser.add_argument("--epochs", type=int, default=250)
    parser.add_argument("--patients", type=int, default=10)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--cache-dtype", default="float32",
                        help="device-cache storage dtype: float32 | "
                             "bfloat16 | uint8 (per-example affine "
                             "quantization; quality A/B knob)")
    parser.add_argument("--ws", action="store_true",
                        help="normalization-free scaled-WS convs instead of "
                             "BatchNorm (an experimental arm: it collapses "
                             "at flagship scale)")
    parser.add_argument("--ema", action="store_true",
                        help="train with an EMA shadow of the params "
                             "(EMA: true, decay 0.999) — checkpoints and "
                             "the evaluation then use the shadow")
    parser.add_argument("--tta", action="store_true",
                        help="after the float evaluation, re-predict the "
                             "same checkpoint with rot90-orbit test-time "
                             "augmentation (TTA: true) into a sibling root "
                             "and print the quality A/B")
    parser.add_argument("--tta-mode", default="coords",
                        choices=["coords", "probs"],
                        help="TTA combiner: 'coords' (identity-anchored) or "
                             "'probs' (reference-style orbit averaging)")
    parser.add_argument("--int8", action="store_true",
                        help="after the float evaluation, quantize the "
                             "trained fold to its int8 serving twin "
                             "(cmrtpu_torch/predict/quantize.py), re-predict "
                             "and re-evaluate — prints the quality A/B")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    args = parser.parse_args(argv)

    from cmrtpu_torch.eval.evaluate import evaluate_cv
    from cmrtpu_torch.tools.columns import mean, report_ab, sd
    from cmrtpu_torch.train.fold import run_experiment

    t0 = time.perf_counter()
    generate_dataset(args.root, n_patients=args.patients, hw=args.dim)
    t1 = time.perf_counter()
    config = quickstart_config(args.root, args.epochs, args.dim,
                               args.cache_dtype, args.ema, args.ws)
    exp_path = run_experiment(config, data_path=args.root,
                              device=args.device)
    t2 = time.perf_counter()

    df = evaluate_cv(exp_path, args.root)
    out = {"exp": exp_path, "df_eval": os.path.join(exp_path, "df_eval.csv"),
           "means": {}, "sd": {}, "tta": None, "int8": None,
           "wall_s": {"dataset": t1 - t0, "train_and_predict": t2 - t1}}
    print("\n=== localisation results (mm) ===")
    for c in QUICK_COLS:
        if c in df:
            out["means"][c], out["sd"][c] = mean(df[c]), sd(df[c])
            print(f"  {c:28s} {out['means'][c]:8.3f} +- {out['sd'][c]:.3f}")
    if any(c in df and math.isnan(mean(df[c]))
           for c in ("mdists_ant_gtpred", "mdists_inf_gtpred")):
        print("  NOTE: NaN volume distances mean a landmark never crossed "
              "the 0.5 detection\n  threshold (volume CoM needs BOTH labels "
              "present) — train more epochs.")
    print(f"df_eval.csv: {out['df_eval']}")

    t3 = time.perf_counter()
    if args.tta:
        from cmrtpu_torch.predict.tta import predict_tta_twin

        t_root = predict_tta_twin(exp_path, mode=args.tta_mode,
                                  device=args.device)
        out["tta"] = report_ab(
            "single-forward vs rot90-TTA (mm / rate)", ("plain", "tta"),
            (df, evaluate_cv(t_root, args.root)),
            (out["df_eval"], os.path.join(t_root, "df_eval.csv")),
            cols=QUICK_COLS, fmt="7.3f", label=28)
        out["wall_s"]["tta"] = time.perf_counter() - t3

    if args.int8:
        from cmrtpu_torch import config as C
        from cmrtpu_torch.predict.predictor import pred_fold
        from cmrtpu_torch.predict.quantize import quantize_fold

        t4 = time.perf_counter()
        calib = sorted(glob.glob(os.path.join(args.root, "2D", "*_img.nrrd")))
        fold_dir = sorted(glob.glob(os.path.join(exp_path, "f[0-9]")))[0]
        # the twin lands in a sibling experiment root, so the evaluation
        # sees one fold family per root
        q_root = exp_path.rstrip("/") + "_int8"
        q_fold = quantize_fold(fold_dir, calib,
                               out_dir=os.path.join(q_root, "f0"),
                               device=args.device)
        pred_fold(C.load_config(os.path.join(q_fold, "config",
                                             "config.json")),
                  device=args.device)
        out["int8"] = report_ab(
            "float vs int8 twin (mm / rate)", ("float", "int8"),
            (df, evaluate_cv(q_root, args.root)),
            (out["df_eval"], os.path.join(q_root, "df_eval.csv")),
            cols=QUICK_COLS, fmt="7.3f", label=28)
        out["wall_s"]["int8"] = time.perf_counter() - t4
    out["wall_s"]["total"] = time.perf_counter() - t0
    print("wall s: " + ", ".join(f"{k} {v:.1f}"
                                 for k, v in out["wall_s"].items()))
    return out


if __name__ == "__main__":
    main()
