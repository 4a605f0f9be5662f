"""mm-level A/B of a trained CV experiment against its int8 PTQ twin —
counterpart of ``tools/int8_ab.py``.

Quantizes every fold (``predict/quantize.py:quantize_fold``; GroupNorm
configs get the GroupNorm affine refit) calibrated on the first
``--calib-studies`` original study files, predicts each fold's test split
with the twin, evaluates both roots and prints the side-by-side
localisation means, then one JSON line of the unrounded means:

    python -m cmrtpu_torch.tools.int8_ab -exp exp/<EXP>/<ts> -data <root>
"""

import argparse
import glob
import os


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="A/B a trained CV root against its int8 PTQ twin")
    parser.add_argument("-exp", required=True,
                        help="trained experiment root (exp/<EXP>/<ts>)")
    parser.add_argument("-data", required=True, help="dataset root")
    parser.add_argument("--calib-studies", type=int, default=16,
                        help="number of original study files to calibrate on")
    parser.add_argument("--device", default="cuda",
                        help="device of calibration and inference "
                             "(default cuda)")
    args = parser.parse_args(argv)

    from cmrtpu_torch import config as C
    from cmrtpu_torch.eval.evaluate import evaluate_cv
    from cmrtpu_torch.predict.predictor import pred_fold
    from cmrtpu_torch.predict.quantize import quantize_fold
    from cmrtpu_torch.tools.columns import report_ab

    calib = sorted(
        f for f in glob.glob(os.path.join(args.data, "original", "*",
                                          "*frame[0-9][0-9].nii.gz"))
        if not f.endswith("_gt.nii.gz"))[:args.calib_studies]
    assert calib, f"no original study files under {args.data}/original"

    plain = evaluate_cv(args.exp, args.data)
    int8_root = None
    for fold_dir in sorted(glob.glob(os.path.join(args.exp, "f[0-9]*"))):
        out = quantize_fold(fold_dir, calib, device=args.device)
        int8_root = os.path.dirname(out)
        pred_fold(C.load_config(os.path.join(out, "config", "config.json")),
                  device=args.device)
    twin = evaluate_cv(int8_root, args.data)
    return report_ab(
        "float vs int8 twin (mean over patient-phases)", ("float", "int8"),
        (plain, twin), (os.path.join(args.exp, "df_eval.csv"),
                        os.path.join(int8_root, "df_eval.csv")))


if __name__ == "__main__":
    main()
