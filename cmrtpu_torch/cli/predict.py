"""CLI: per-fold inference on a CUDA device.

``python -m cmrtpu_torch.cli.predict -exp <fold_dir> -data <root>
[--device cuda]``

Counterpart of ``cmrtpu/cli/predict.py`` (flag parity with
``python src/models/predict_model.py -exp <fold_dir> -data <root>``):
restores ``<fold_dir>/model`` with ``<fold_dir>/config/config.json`` and
rewrites the fold's ``pred/`` and ``gt/`` through ``pred_fold``. ``-data``
holds ``2D/``, ``df_kfold.csv`` and ``original/``. The device defaults to
cuda and a missing card raises unless ``--device cpu`` is given.
"""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="predict a trained RVIP fold")
    parser.add_argument("-exp", action="store", default=None,
                        help="path to a fold experiment dir (contains "
                             "config/config.json)")
    parser.add_argument("-data", action="store", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")
    if args.exp is None:
        parser.error("no fold directory given (-exp)")

    cfg_path = os.path.join(args.exp, "config", "config.json")
    with open(cfg_path, encoding="utf-8") as fh:
        config = json.load(fh)
    config["MODEL_PATH"] = os.path.join(args.exp, "model")
    config["EXP_PATH"] = args.exp
    if args.data:
        config["DATA_PATH_SAX"] = os.path.join(args.data, "2D")
        df_folds = os.path.join(args.data, "df_kfold.csv")
        config["DF_FOLDS"] = df_folds if os.path.isfile(df_folds) else None
        config["DATA_PATH_ORIG"] = os.path.join(args.data, "original")

    from cmrtpu_torch.predict.predictor import pred_fold
    return pred_fold(config, device=args.device)


if __name__ == "__main__":
    main()
