"""CLI: run a trained 2D cross-validation over whole 4D cine sequences on a
CUDA device.

``python -m cmrtpu_torch.cli.predict_4d -exp <exp_root> -data <root>
[-suffix pred_4d] [--device cuda]``

Counterpart of ``cmrtpu/cli/predict_4d.py`` (flag parity with
``python src/models/predict_4d_on_seg.py -exp <exp_root> -data <root>``):
every fold ``f<k>`` of the experiment root predicts the
``<root>/original/*/*4d.nii.gz`` files of its test patients into
``f<k>/<suffix>/<stem>_pred.nrrd`` through ``predict_4d_on_2d_cv``. The
device defaults to cuda and a missing card raises unless ``--device cpu``
is given.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="predict 4D cine CMR with a trained 2D cross-validation")
    parser.add_argument("-exp", action="store", default=None,
                        help="experiment root containing the f<k> fold dirs")
    parser.add_argument("-data", action="store", default=None,
                        help="data root (original/ with *4d.nii.gz files)")
    parser.add_argument("-suffix", action="store", default="pred_4d",
                        help="per-fold export sub-directory name")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")
    if args.exp is None:
        parser.error("no experiment root given (-exp)")
    if args.data is None:
        parser.error("no data root given (-data)")

    from cmrtpu_torch.predict.predictor import predict_4d_on_2d_cv
    predict_4d_on_2d_cv(args.exp, args.data, export_suffix=args.suffix,
                        device=args.device)


if __name__ == "__main__":
    main()
