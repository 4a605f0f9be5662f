"""Quality loop for the 2D+t cine configuration (BASELINE.json config 3)
through cmrtpu_torch — counterpart of ``examples/cine_quality_demo.py``.

Generates synthetic cine SAX stacks whose two RV insertion points move
smoothly over the cardiac cycle (a contraction toward the stack centre and
back), trains a 3D (t, y, x) U-Net through the device-resident loop
(``Trainer.fit_cached``: augmentation with one draw per stack, σ heatmap
targets on K1) and reports the per-frame localisation error in mm on
held-out patients for both detection strategies (CoM, the reference's, and
argmax), the landmarks never detected and the wall time, then the card's
name and power limit; ``<root>/summary.json`` keeps them.

    python -m cmrtpu_torch.tools.cine_quality_demo --patients 12 --epochs 600

``--patients 4 --epochs 2 --dim 32 --t-frames 4 --device cpu`` is a
CPU-sized smoke run. ``--variant`` sets MODEL_VARIANT: ``unet`` (default),
``unet_2p1d`` (the (2+1)D U-Net) or a 2D-in-3D hybrid (``wrapper``,
``followed``, ``concat``, ``avg``, ``avg_plain``).
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

SPACING_MM = 1.4


def generate_cine_cohort(root, n_patients, t_frames, hw, seed=0):
    """Per-patient cine stacks [t, hw, hw]: landmarks oscillate toward the
    centre over t (systole-like motion), the image carries a bright
    (anterior, label 1) and a dark (inferior, label 2) 3x3 cue on noise.
    Returns the image and mask paths and the ground truth per patient,
    [t, (ant, inf), (y, x)]. The same draws as cmrtpu's demo."""
    from cmrtpu_torch.io import MedicalImage, write_image
    from cmrtpu_torch.utils.io_utils import ensure_dir

    rng = np.random.default_rng(seed)
    ensure_dir(root)
    xs, ys, gts = [], [], {}
    for p in range(n_patients):
        pid = f"patient{p:03d}"
        ant0 = np.array([hw // 3 + rng.integers(-3, 4),
                         2 * hw // 3 + rng.integers(-3, 4)], float)
        inf0 = np.array([2 * hw // 3 + rng.integers(-3, 4),
                         hw // 3 + rng.integers(-3, 4)], float)
        centre = np.array([hw / 2, hw / 2])
        img = rng.normal(0, 0.2, size=(t_frames, hw, hw)).astype(np.float32)
        msk = np.zeros((t_frames, hw, hw), np.uint8)
        gt = np.zeros((t_frames, 2, 2), float)
        for t in range(t_frames):
            # contraction phase: 0 -> ~20% toward the centre -> back
            phase = 0.2 * np.sin(np.pi * t / max(t_frames - 1, 1))
            a = np.round(ant0 + phase * (centre - ant0)).astype(int)
            i = np.round(inf0 + phase * (centre - inf0)).astype(int)
            img[t, a[0] - 1:a[0] + 2, a[1] - 1:a[1] + 2] += 2.0
            img[t, i[0] - 1:i[0] + 2, i[1] - 1:i[1] + 2] -= 2.0
            msk[t, a[0] - 1:a[0] + 2, a[1] - 1:a[1] + 2] = 1
            msk[t, i[0] - 1:i[0] + 2, i[1] - 1:i[1] + 2] = 2
            gt[t, 0], gt[t, 1] = a, i
        xp = os.path.join(root, f"{pid}__cine_img.nrrd")
        yp = os.path.join(root, f"{pid}__cine_msk.nrrd")
        spacing = (SPACING_MM,) * 2 + (1.0,)
        write_image(MedicalImage(array=img, spacing=spacing), xp)
        write_image(MedicalImage(array=msk, spacing=spacing), yp)
        xs.append(xp)
        ys.append(yp)
        gts[pid] = gt
    return xs, ys, gts


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _errors(trainer, test_x, test_y, cfg):
    """Held-out per-frame localisation: distances in mm for each detection
    strategy where the gt and the prediction both detect, and the gt
    landmarks the CoM strategy misses."""
    from cmrtpu_torch.eval.detection import detect
    from cmrtpu_torch.pipeline.generator import DataGenerator, finalize_batch

    # the deterministic stage only: no augmentation, binary masks, so the
    # gt positions come from the geometry the model saw
    test_cfg = dict(cfg, AUGMENT=False, GAUS=False, SHUFFLE=False)
    gen = DataGenerator(test_x, test_y, config=test_cfg)
    x, y = finalize_batch(torch.from_numpy(gen._cache_x),
                          torch.from_numpy(gen._cache_y), test_cfg)
    preds = trainer.predict(x.numpy())
    n, t = preds.shape[:2]
    flat_pred = torch.from_numpy(preds.reshape(n * t, *preds.shape[2:]))
    flat_gt = y.reshape(n * t, *y.shape[2:])
    gt_coords, gt_valid = detect(flat_gt, strategy="com")
    errs, missed = {"com": [], "argmax": []}, 0
    for strategy in errs:
        coords, valid = detect(flat_pred, strategy=strategy)
        ok = gt_valid & valid
        d = torch.linalg.norm(coords - gt_coords, dim=-1)
        errs[strategy] = (d[ok] * SPACING_MM).tolist()
        if strategy == "com":
            missed = int((gt_valid & ~valid).sum())
    return errs, missed


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default="/tmp/cmrtpu_torch_cine_demo")
    parser.add_argument("--patients", type=int, default=16)
    parser.add_argument("--t-frames", type=int, default=8)
    parser.add_argument("--dim", type=int, default=48)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--sigma", type=float, default=2)
    parser.add_argument("--pool-t", action="store_true",
                        help="M_POOL=[2,2,2]: pool the t axis too; the "
                             "decoder upsamples t back, so the output "
                             "stays per-frame")
    parser.add_argument("--variant", default="unet",
                        help="MODEL_VARIANT (e.g. unet_2p1d, or 'wrapper' "
                             "for the slice-wise 2D hybrid)")
    parser.add_argument("--depth", type=int, default=3,
                        help="U-Net DEPTH (4 is the published 3D template's)")
    parser.add_argument("--filters", type=int, default=8)
    parser.add_argument("--budget-s", type=float, default=0,
                        help="train until this many seconds elapse (epochs "
                             "becomes an upper bound)")
    parser.add_argument("--group-norm", type=int, default=0,
                        help="GROUP_NORM groups (0 = BatchNorm)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions "
                             "of the kernels")
    args = parser.parse_args(argv)

    from cmrtpu_torch.pipeline.generator import DataGenerator
    from cmrtpu_torch.train.callbacks import TimeBudget
    from cmrtpu_torch.train.trainer import Trainer

    xs, ys, _ = generate_cine_cohort(args.root, args.patients, args.t_frames,
                                     args.dim)
    n_test = max(2, args.patients // 4)
    train_x, train_y = xs[:-n_test], ys[:-n_test]
    test_x, test_y = xs[-n_test:], ys[-n_test:]

    cfg = {"DIM": [args.t_frames, args.dim, args.dim],
           "MODEL_VARIANT": args.variant,
           "F_SIZE": [3, 3, 3],
           "M_POOL": [2, 2, 2] if args.pool_t else [1, 2, 2],
           "DEPTH": args.depth, "FILTERS": args.filters,
           "GROUP_NORM": args.group_norm,
           "BATCHSIZE": min(4, len(train_x)),
           "MASK_VALUES": [1, 2], "MASK_CLASSES": 2, "SEED": 42,
           "OPTIMIZER": "adam", "LEARNING_RATE": 1e-3,
           "LOSS_FUNCTION": "BceDiceLoss", "SCALER": "MinMax",
           "RESAMPLE": False, "MIXED_PRECISION": True,
           "AUGMENT": True, "AUGMENT_PROB": 0.8, "RANDOMROTATE": True,
           "SHIFTSCALEROTATE": True, "GRIDDISTORTION": True,
           "GAUS": args.sigma > 0, "SIGMA": args.sigma}

    trainer = Trainer(cfg, device=args.device)
    callbacks, epochs = [], args.epochs
    if args.budget_s > 0:
        callbacks.append(TimeBudget(args.budget_s))
        epochs = max(args.epochs, 1_000_000)  # the budget decides
    t0 = time.time()
    hist = trainer.fit_cached(DataGenerator(train_x, train_y, config=cfg),
                              epochs=epochs, callbacks=callbacks)
    wall = time.time() - t0
    n_epochs = len(hist)
    frames = len(train_x) * args.t_frames * n_epochs
    print(f"train loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({n_epochs} epochs, {wall:.1f}s wall, "
          f"{frames / max(wall, 1e-9):.1f} frames/s incl. set-up)")

    errs, missed = _errors(trainer, test_x, test_y, cfg)
    print(f"\n=== held-out per-frame localisation, {n_test} patients x "
          f"{args.t_frames} frames (mm @ {SPACING_MM} mm spacing) ===")
    summary = {"variant": args.variant, "patients": args.patients,
               "test_patients": n_test,
               "t_frames": args.t_frames, "dim": args.dim,
               "epochs": n_epochs, "train_wall_s": wall,
               "frames_per_s": frames / max(wall, 1e-9),
               "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
               "landmarks": 2 * n_test * args.t_frames,
               "landmarks_missed": missed, "device": args.device,
               "card": _card() if args.device.startswith("cuda") else None}
    for strategy, d in errs.items():
        d = np.array(d)
        if len(d) == 0:
            print(f"  {strategy:7s} no landmark crossed the 0.5 threshold "
                  f"— train more epochs")
            continue
        print(f"  {strategy:7s} mean {d.mean():6.3f} +- {d.std():.3f}   "
              f"p95 {np.percentile(d, 95):6.3f}   n={len(d)}")
        summary.update({f"{strategy}_mean_mm": float(d.mean()),
                        f"{strategy}_std_mm": float(d.std()),
                        f"{strategy}_p95_mm": float(np.percentile(d, 95)),
                        f"{strategy}_n": int(len(d))})
    print(f"  landmarks missed (never crossed 0.5): {missed}")
    print(f"card: {summary['card']}")
    with open(os.path.join(args.root, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
