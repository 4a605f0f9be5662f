"""CLI: train a RVIP detection model on a CUDA device.

``python -m cmrtpu_torch.cli.train -cfg <config.json> -data <root>
[-inmemory true] [-resume <run_dir>] [--device cuda]``

Counterpart of ``cmrtpu/cli/train.py`` (flag parity with
``python src/models/train_model.py -cfg <json> -data <root>``). ``-data``
holds ``2D/`` and ``df_kfold.csv``; every fold of FOLDS trains in turn into
``EXPERIMENTS_ROOT/EXPERIMENT/<timestamp>/f<k>/``. The device defaults to
cuda and a missing card raises unless ``--device cpu`` is given.
``-resume <run_dir>`` re-enters an existing timestamped run: each fold
restores its full train state and continues its epoch count, and a
completed fold is skipped. ``-inmemory false`` keeps no host cache: each
fold then trains from packed host-streamed batches
(``cmrtpu_torch/train/streaming.py``).

More than one process: ``torchrun --nproc_per_node N -m
cmrtpu_torch.cli.train -cfg ... -data ...`` trains each fold over N ranks,
one card each (nccl; gloo with ``--device cpu``), as do cmrtpu's
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
(``parallel/mesh.py:initialize_distributed``). Without them the CLI runs
one process as before.
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train a RV IP detection/segmentation model on CMR "
                    "images (PyTorch + CUDA)")
    parser.add_argument("-cfg", action="store", default=None,
                        help="path to an experiment config (exp/template_cfgs)")
    parser.add_argument("-data", action="store", default=None,
                        help="path to the data-root folder (2D/, df_kfold.csv)")
    parser.add_argument("-inmemory", action="store", default=None,
                        help="cache the deterministic preprocessing in RAM "
                             "and hold the dataset on the card (default); "
                             "false streams packed host batches to the "
                             "card instead")
    parser.add_argument("-resume", action="store", default=None,
                        help="path to an existing timestamped run "
                             "(exp/<EXP>/<ts>) to resume after a crash: "
                             "each fold restores its full train state and "
                             "continues its epoch count")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")
    if args.cfg is None:
        parser.error("no config given (-cfg)")
    if args.data is None:
        parser.error("no data given (-data)")
    in_memory = args.inmemory is None or \
        args.inmemory.strip().lower() not in ("0", "false", "no", "off")

    with open(args.cfg, encoding="utf-8") as fh:
        config = json.load(fh)
    if args.resume:
        config["RESUME"] = True

    from cmrtpu_torch.parallel import mesh as M
    from cmrtpu_torch.train.fold import run_experiment
    joined = not M.dist.is_initialized() and \
        M.initialize_distributed(device=args.device)
    try:
        return run_experiment(config, data_path=args.data,
                              exp_path=args.resume, in_memory=in_memory,
                              device=args.device)
    finally:
        if joined:  # a group this call made, this call leaves
            M.shutdown_distributed()


if __name__ == "__main__":
    main()
