"""CLI: batch serving over a directory of CMR studies on a CUDA device.

``python -m cmrtpu_torch.cli.serve -exp <fold_dir> -in <dir> -out <dir>
[--device cuda] [--watch] [--poll 2.0] [--stats <file.jsonl>]
[--max-studies N]``

or ``-artifact <export_dir>`` (a ``cmrtpu_torch.cli.export`` output, served
without the model code) or ``-ensemble <exp_root>`` (every fold of a CV
root as one vmapped average-probability ensemble) in place of ``-exp``.

Counterpart of ``cmrtpu/cli/serve.py``. Restores once, then streams every
``*.nii.gz`` / ``*.nii`` / ``*.nrrd`` study in ``-in`` through the model and
writes ``<stem>_<head>_pred.nrrd`` in each study's original geometry into
``-out``, with per-study latency records in ``<stem>.done.json`` markers.
Prints the totals as one JSON line.
"""

import argparse
import json
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="serve CMR landmark predictions over a study directory "
                    "(PyTorch + CUDA)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("-artifact", action="store",
                     help="serving artifact dir (cmrtpu_torch.cli.export "
                          "output)")
    src.add_argument("-exp", action="store",
                     help="trained fold dir (config/config.json + model/)")
    src.add_argument("-ensemble", action="store",
                     help="timestamped experiment root (exp/<EXP>/<ts>): "
                          "serve all fold checkpoints as one vmapped "
                          "average-probability ensemble")
    parser.add_argument("-in", dest="in_dir", action="store", required=True,
                        help="directory of input studies (nii/nii.gz/nrrd)")
    parser.add_argument("-out", dest="out_dir", action="store", required=True,
                        help="output directory for predictions + markers")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    parser.add_argument("--watch", action="store_true",
                        help="keep polling for new studies (Ctrl-C to stop)")
    parser.add_argument("--poll", type=float, default=2.0,
                        help="watch-mode poll interval in seconds")
    parser.add_argument("--stats", action="store",
                        help="append per-study latency records to this JSONL")
    parser.add_argument("--max-studies", type=int, default=None,
                        help="stop after N studies (drain/smoke runs)")
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")
    logging.basicConfig(level=logging.INFO)

    from cmrtpu_torch.predict.serving import ServingEngine, serve_directory

    if args.artifact:
        engine = ServingEngine(artifact_dir=args.artifact, device=args.device)
    elif args.ensemble:
        engine = ServingEngine(ensemble_root=args.ensemble,
                               device=args.device)
    else:
        cfg_path = os.path.join(args.exp, "config", "config.json")
        with open(cfg_path, encoding="utf-8") as fh:
            config = json.load(fh)
        engine = ServingEngine(config=config,
                               model_path=os.path.join(args.exp, "model"),
                               device=args.device)
    try:
        totals = serve_directory(engine, args.in_dir, args.out_dir,
                                 watch=args.watch, poll_s=args.poll,
                                 stats_path=args.stats,
                                 max_studies=args.max_studies)
    except KeyboardInterrupt:
        totals = engine.totals()
    print(json.dumps(totals))
    return totals


if __name__ == "__main__":
    main()
