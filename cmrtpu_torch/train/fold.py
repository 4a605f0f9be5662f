"""Per-fold training — counterpart of ``cmrtpu/train/fold.py`` (parity with
src/models/train_model.py).

``train_fold``: fold paths, the saved config, train and val generators (val
with AUGMENT and HIST_MATCHING off; not in memory with ``CACHE_PER_HOST``),
the model summary, the ImageWriter's sample batches (batch 0 of each
generator, drawn as cmrtpu draws them), the callback set, the fit (``_picks_device_cache``: the
device-resident loop when the cache fits DEVICE_CACHE_LIMIT_GB, else packed
host streaming), the chained ``pred_fold`` on the same device and
``fold_complete.json``. cmrtpu logs and swallows any error of the chained
prediction; here it propagates, so a fault in the prediction path (K1, K2)
cannot hide behind a fold that reports success.
``run_experiment``: the timestamped EXP_PATH, data paths, one fold after
another over FOLDS.

Over a process group every rank trains the fold (``trainer.mesh``); rank
0 alone writes the config, the summary and ``fold_complete.json`` and
runs the chained ``pred_fold`` while the others wait at a barrier (cmrtpu
predicts on every process), and ``run_experiment`` takes rank 0's run dir.

``RESUME``: ``run_experiment`` re-enters the run (the given exp_path, the
config's EXP_PATH when it lies under this experiment's root, else the
latest run dir); ``train_fold`` skips a fold whose ``fold_complete.json``
targets at least EPOCHS, and otherwise restores the fold's full train state
(``Trainer.restore``) and continues at epoch ``step // _steps_per_epoch``
with ``history.csv`` cut to the epochs before it.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
from time import time
from typing import Dict, List, Optional

from cmrtpu_torch import config as C
from cmrtpu_torch.data.dataset import get_trainings_files
from cmrtpu_torch.models.unet import model_summary
from cmrtpu_torch.parallel import mesh as M
from cmrtpu_torch.pipeline.generator import DataGenerator
from cmrtpu_torch.predict.predictor import pred_fold
from cmrtpu_torch.train import callbacks as CB
from cmrtpu_torch.train.callbacks import get_callbacks
from cmrtpu_torch.train.device_cache import (_gen_examples, cache_shards,
                                             fits_device_cache,
                                             per_host_cache)
from cmrtpu_torch.train.trainer import Trainer
from cmrtpu_torch.utils.io_utils import console_and_file_logger

_FOLD_COMPLETE = "fold_complete.json"


def _truncate_history(path: str, epochs: int,
                      write: bool = True) -> List[Dict[str, float]]:
    """Keep the header and the rows of epochs < ``epochs`` of a history.csv,
    byte for byte (the port's 6-significant-digit rows are not reformatted;
    the file is left as it is unless ``write``), and return those rows
    without ``epoch`` as floats."""
    with open(path, newline="") as fh:
        lines = fh.read().splitlines(keepends=True)
    header = next(csv.reader(lines[:1]))
    kept, rows = lines[:1], []
    for line in lines[1:]:
        values = next(csv.reader([line]))
        if int(values[0]) < epochs:
            kept.append(line)
            rows.append({k: float(v) for k, v in zip(header[1:],
                                                     values[1:])})
    if write:
        with open(path, "w", newline="") as fh:
            fh.writelines(kept)
    return rows


def _picks_device_cache(cfg: Dict, train_gen,
                        mesh: Optional[M.Mesh] = None) -> bool:
    """The fold's data loop: device-cached when the per-host cache is asked
    for or the packed cache fits DEVICE_CACHE_LIMIT_GB (per device, so a
    cache sharded over n shards may be n times larger), packed host
    streaming otherwise (a generator without its in-memory cache too).
    Memoized on the generator: the packability scan walks its whole mask
    cache."""
    n_shards = cache_shards(cfg, mesh or M.Mesh())
    key = (str(C.get(cfg, "CACHE_DTYPE", "float32")),
           float(C.get(cfg, "DEVICE_CACHE_LIMIT_GB", 8.0) or 8.0), n_shards,
           per_host_cache(cfg))
    memo = getattr(train_gen, "_picks_cache_memo", None)
    if memo is not None and memo[0] == key:
        return memo[1]
    if per_host_cache(cfg):
        result = True  # rows load per host: there is no host cache to scan
    else:
        result = getattr(train_gen, "_cache_x", None) is not None and \
            fits_device_cache(cfg, train_gen._cache_x, train_gen._cache_y,
                              n_shards=n_shards)
    train_gen._picks_cache_memo = (key, result)
    return result


def _steps_per_epoch(cfg: Dict, train_gen,
                     mesh: Optional[M.Mesh] = None) -> int:
    """Optimizer steps one epoch takes in the loop ``train_fold`` picks:
    floor(n / B) on the replicated cache, ceil(n / shards) // (B / shards)
    over the wrap-padded shards of the sharded one, ``len(train_gen) *
    STREAM_ECHO`` streamed."""
    batch = max(1, int(C.get(cfg, "BATCHSIZE", 32) or 1))
    if _picks_device_cache(cfg, train_gen, mesh):
        n = _gen_examples(train_gen)
        if bool(C.get(cfg, "CACHE_SHARDED", False)):
            n_shards = cache_shards(cfg, mesh or M.Mesh())
            return max(1, -(-n // n_shards) // max(1, batch // n_shards))
        return max(1, n // batch)
    echo = max(1, int(C.get(cfg, "STREAM_ECHO", 1) or 1))
    return max(1, len(train_gen)) * echo


def _resume_fold(trainer: Trainer, cfg: Dict, train_gen,
                 callbacks) -> int:
    """Crash recovery (cmrtpu's ``_resume_fold``): restore the fold's full
    train state from MODEL_PATH (the best-only checkpoint ModelCheckpoint
    wrote) and continue at epoch ``restored_step // _steps_per_epoch``,
    the steps an epoch of the picked loop takes. history.csv is cut to
    the epochs before it and reloaded into ``trainer.history``;
    ModelCheckpoint's best is seeded from those rows, so a worse epoch
    after the resume never overwrites the checkpoint. The epochs between
    the best checkpoint and the crash are trained again; the plateau and
    early-stop counters start afresh (a reduced learning rate is part of
    the restored state). No state on disk: warn and train from scratch."""
    model_path = C.get(cfg, "MODEL_PATH")
    try:
        restored_step = trainer.restore(model_path)
    except FileNotFoundError as e:
        logging.warning("RESUME requested but no restorable train state "
                        "under %s (%s); training from scratch", model_path, e)
        return 0
    initial_epoch = restored_step // _steps_per_epoch(cfg, train_gen,
                                                      trainer.mesh)
    hist_path = os.path.join(cfg["EXP_PATH"], "history.csv")
    rows = []
    if os.path.isfile(hist_path) and initial_epoch > 0:
        rows = _truncate_history(hist_path, initial_epoch, write=False)
        M.barrier(trainer.mesh)  # every rank has read it: rank 0 cuts it
        if M.is_main_process():
            _truncate_history(hist_path, initial_epoch)
    trainer.history = rows
    for cb in callbacks:
        if isinstance(cb, CB.HistoryCSV):
            cb.append = True
        if isinstance(cb, CB.ModelCheckpoint):
            # a checkpoint exists on disk: the never-improved fallback at
            # train end must not overwrite it with a worse final state
            cb._saved = True
            CB.seed_best_from_history(cb, rows)
    logging.info("RESUME: restored step %d from %s -> continuing at epoch %d",
                 restored_step, model_path, initial_epoch)
    return initial_epoch


def _fold_complete_path(cfg: Dict) -> str:
    return os.path.join(cfg.get("FOLD_PATH", cfg["EXP_PATH"]), _FOLD_COMPLETE)


def _fold_already_complete(cfg: Dict) -> bool:
    """True when the fold's completion marker exists and EPOCHS does not
    ask for more than the completed run targeted: a resumed CV retrains
    only the fold that crashed, and raising EPOCHS is the explicit
    train-longer request that re-enters a finished fold."""
    path = _fold_complete_path(cfg)
    if not os.path.isfile(path):
        return False
    try:
        with open(path) as fh:
            target = int(json.load(fh).get("epochs_target", 0))
    except (ValueError, OSError):
        return True  # unreadable marker: the fold did finish — stay safe
    return int(C.get(cfg, "EPOCHS", 100) or 100) <= target


def train_fold(config: Dict, in_memory: bool = True,
               device="cuda") -> Optional[Trainer]:
    """Train one fold on ``device`` and return its Trainer, or None when
    RESUME finds the fold complete and skips it."""
    t0 = time()
    fold = C.get(config, "FOLD", 0)
    cfg = C.set_experiment_paths(C.normalise_config(config), fold=fold)
    resume = bool(C.get(cfg, "RESUME", False))
    if resume and _fold_already_complete(cfg):
        logging.info("RESUME: fold %s already complete (%s) — skipping",
                     fold, _fold_complete_path(cfg))
        return None

    console_and_file_logger(path=cfg["EXP_PATH"], log_lvl=logging.INFO)
    main = M.is_main_process()
    cfg = C.init_config(cfg, save=main)

    x_train, y_train, x_val, y_val = get_trainings_files(
        data_path=C.get(cfg, "DATA_PATH_SAX"),
        path_to_folds_df=C.get(cfg, "DF_FOLDS"), fold=fold)
    logging.info("SAX train CMR: %d, SAX train masks: %d", len(x_train),
                 len(y_train))
    logging.info("SAX val CMR: %d, SAX val masks: %d", len(x_val), len(y_val))

    if per_host_cache(cfg):
        in_memory = False  # the loop loads its rows through fixed_rows
    batch_generator = DataGenerator(x_train, y_train, config=cfg,
                                    in_memory=in_memory, device=device)
    val_config = dict(cfg)
    val_config["AUGMENT"] = False          # no augmentation on validation data
    val_config["AUGMENT_GRID"] = False
    val_config["HIST_MATCHING"] = False
    validation_generator = DataGenerator(x_val, y_val, config=val_config,
                                         in_memory=in_memory, device=device)

    logging.info("Create model")
    trainer = Trainer(cfg, device=device)
    fold_root = cfg.get("FOLD_PATH", cfg["EXP_PATH"])
    if main:
        with open(os.path.join(fold_root, "model_summary.txt"), "w") as fh:
            fh.write(model_summary(trainer.model) + "\n")

    # the ImageWriter's fixed train/val batches, drawn as cmrtpu draws them:
    # always, before any resume (with HIST_MATCHING the train batch moves
    # the generator's rng, so every later epoch order depends on it)
    sample_batches = None
    if len(batch_generator) and len(validation_generator):
        sample_batches = [
            (name, *(CB.host_numpy(a) for a in gen[0])) for name, gen in
            (("train", batch_generator), ("val", validation_generator))]

    fold_cfg = dict(cfg)
    fold_cfg["EXP_PATH"] = fold_root  # per-fold artifacts under f<k>/
    callbacks = get_callbacks(fold_cfg, sample_batches=sample_batches)
    initial_epoch = 0
    if resume:
        initial_epoch = _resume_fold(trainer, fold_cfg, batch_generator,
                                     callbacks)
    logging.info("start training")
    fit = trainer.fit_cached if _picks_device_cache(
        cfg, batch_generator, trainer.mesh) else trainer.fit_streamed
    fit(batch_generator, val_gen=validation_generator,
        epochs=C.get(cfg, "EPOCHS", 100), callbacks=callbacks,
        initial_epoch=initial_epoch)

    try:
        if main:
            pred_fold(dict(cfg, EXP_PATH=fold_root), device=trainer.device)
            with open(_fold_complete_path(cfg), "w") as fh:
                json.dump({"fold": fold, "epochs_run": len(trainer.history),
                           "epochs_target": int(C.get(cfg, "EPOCHS", 100)
                                                or 100),
                           "finished_at": time()}, fh)
    finally:  # the other ranks wait here for rank 0's prediction
        M.barrier(trainer.mesh)
    logging.info("Fold %s finished after %0.3f sec", fold, time() - t0)
    return trainer


def _latest_run_dir(cfg: Dict) -> Optional[str]:
    """The most recent timestamped run dir under EXPERIMENTS_ROOT/EXPERIMENT
    (the exp/<EXP>/<YYYY-MM-DD_HH_MM>/ layout), or None."""
    root = os.path.join(C.get(cfg, "EXPERIMENTS_ROOT", "exp/"),
                        str(C.get(cfg, "EXPERIMENT", "")))
    runs = sorted(d for d in glob.glob(os.path.join(root, "*"))
                  if os.path.isdir(d))
    return runs[-1] if runs else None


def _resume_run_dir(cfg: Dict) -> Optional[str]:
    """The run a RESUME without an explicit run dir re-enters: the config's
    own EXP_PATH (a reloaded config/config.json carries it) when it lies
    under this experiment's root — a config copied from another
    experiment's run must not train into that run — else the latest run
    dir of this experiment."""
    root = os.path.realpath(os.path.join(
        C.get(cfg, "EXPERIMENTS_ROOT", "exp/"),
        str(C.get(cfg, "EXPERIMENT", ""))))
    prior = C.get(cfg, "EXP_PATH")
    if prior and os.path.isdir(prior) and \
            not os.path.realpath(prior).startswith(root + os.sep):
        logging.warning(
            "RESUME: ignoring config EXP_PATH %s — it does not belong to "
            "experiment %r (expected under %s); falling back to the latest "
            "run dir", prior, C.get(cfg, "EXPERIMENT", ""), root)
        prior = None
    exp_path = prior if prior and os.path.isdir(prior) \
        else _latest_run_dir(cfg)
    if exp_path:
        logging.info("RESUME: re-entering run dir %s", exp_path)
    else:
        logging.warning("RESUME requested but no prior run dir found under "
                        "EXPERIMENTS_ROOT/EXPERIMENT; starting a fresh run")
    return exp_path


def run_experiment(config: Dict, data_path: Optional[str] = None,
                   exp_path: Optional[str] = None, in_memory: bool = True,
                   device="cuda") -> str:
    """Loop FOLDS calling train_fold (ref: main, train_model.py:135-206).
    Returns the experiment path."""
    cfg = C.normalise_config(config)
    if exp_path is None and C.get(cfg, "RESUME", False):
        exp_path = _resume_run_dir(cfg)
    cfg["EXP_PATH"] = M.broadcast_object(
        exp_path or C.timestamped_exp_path(cfg), M.create_mesh())
    if data_path:
        cfg["DATA_PATH_SAX"] = os.path.join(data_path, "2D")
        cfg["DF_FOLDS"] = os.path.join(data_path, "df_kfold.csv")
        cfg["DATA_PATH_ORIG"] = os.path.join(data_path, "original")
    for f in C.get(cfg, "FOLDS", [0]):
        print(f"starting fold: {f}")
        fold_cfg = dict(cfg)
        fold_cfg["FOLD"] = f
        train_fold(fold_cfg, in_memory=in_memory, device=device)
        print(f"training of fold: {f} finished")
    return cfg["EXP_PATH"]
