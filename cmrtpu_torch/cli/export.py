"""CLI: export a trained fold for serving without the model code.

``python -m cmrtpu_torch.cli.export -exp <fold_dir> -out <dir> [--batch 8]
[--fold-bn] [--int8 --calib <study_dir> [--calib-slices 256]]
[--device cuda]``

Counterpart of ``cmrtpu/cli/export.py``: writes ``forward.pt2`` (a
``torch.export`` program at a fixed batch, TTA baked in when the fold sets
it), ``weights.npz`` and ``export.json`` (``predict/export.py``), which
``python -m cmrtpu_torch.cli.serve -artifact <dir>`` serves. ``--fold-bn``
folds frozen BatchNorm into the conv weights first (BN_FIRST configs);
``--int8`` exports the post-training-quantized twin, calibrated on the
image studies under ``--calib``. The program is bound to the device type
it was traced on (``--device``).
"""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="export a trained fold's forward pass for serving "
                    "(PyTorch + CUDA)")
    parser.add_argument("-exp", action="store", required=True,
                        help="fold experiment dir (contains config/config.json"
                             " and model/)")
    parser.add_argument("-out", action="store", required=True,
                        help="output dir for the artifact + weights")
    parser.add_argument("--batch", type=int, default=8,
                        help="batch size baked into the exported interface")
    parser.add_argument("--fold-bn", action="store_true",
                        help="fold frozen BatchNorm into conv weights "
                             "(BN_FIRST configs)")
    parser.add_argument("--int8", action="store_true",
                        help="export the post-training-quantized int8 twin "
                             "— needs --calib")
    parser.add_argument("--calib", action="store",
                        help="directory of representative studies "
                             "(.nii/.nii.gz/.nrrd) for int8 calibration")
    parser.add_argument("--calib-slices", type=int, default=256,
                        help="max calibration slices drawn from --calib")
    parser.add_argument("--device", default="cuda",
                        help="torch device to trace (and serve) on (default "
                             "cuda; cpu only when asked for)")
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")

    with open(os.path.join(args.exp, "config", "config.json"),
              encoding="utf-8") as fh:
        config = json.load(fh)
    model_path = os.path.join(args.exp, "model")

    int8_calib = None
    if args.int8:
        if not args.calib:
            parser.error("--int8 needs --calib <dir of studies>")
        # the serving engine's study discovery, without the label families:
        # scales calibrated on masks would skew the range for real images
        from cmrtpu_torch.predict.serving import (DEFAULT_PATTERNS,
                                                  LABEL_SUFFIXES, _worklist)
        paths = _worklist(args.calib, DEFAULT_PATTERNS,
                          exclude=LABEL_SUFFIXES)
        if not paths:
            parser.error(f"no image studies found under {args.calib}")
        from cmrtpu_torch.predict.quantize import \
            calibration_batches_from_studies
        int8_calib = calibration_batches_from_studies(
            paths, config, batch=args.batch, max_slices=args.calib_slices)
    elif args.calib:
        parser.error("--calib only applies with --int8")

    from cmrtpu_torch.predict.export import export_model
    out = export_model(config, model_path, args.out, batch=args.batch,
                       fold_bn=args.fold_bn, int8_calib=int8_calib,
                       device=args.device)
    print(f"exported serving artifact to {out}")
    return out


if __name__ == "__main__":
    main()
