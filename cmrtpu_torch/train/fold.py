"""Per-fold training — counterpart of ``cmrtpu/train/fold.py`` (parity with
src/models/train_model.py).

``train_fold``: fold paths, the saved config, train and val generators (val
with AUGMENT and HIST_MATCHING off), the model summary, the callback set,
the device-resident fit, the chained ``pred_fold`` on the same device and
``fold_complete.json``. cmrtpu logs and swallows any error of the chained
prediction; here it propagates, so a fault in the prediction path (K1, K2)
cannot hide behind a fold that reports success.
``run_experiment``: the timestamped EXP_PATH, data paths, one fold after
another over FOLDS.

Not ported yet: ``RESUME`` (ROADMAP 3.6, it raises).
"""

from __future__ import annotations

import json
import logging
import os
from time import time
from typing import Dict, Optional

from cmrtpu_torch import config as C
from cmrtpu_torch.data.dataset import get_trainings_files
from cmrtpu_torch.models.unet import model_summary
from cmrtpu_torch.pipeline.generator import DataGenerator
from cmrtpu_torch.predict.predictor import pred_fold
from cmrtpu_torch.train.callbacks import get_callbacks
from cmrtpu_torch.train.trainer import Trainer
from cmrtpu_torch.utils.io_utils import console_and_file_logger

_FOLD_COMPLETE = "fold_complete.json"


def _no_resume(cfg: Dict) -> None:
    if C.get(cfg, "RESUME", False):
        raise NotImplementedError(
            "RESUME (full-state resume of a crashed fold) is not ported to "
            "cmrtpu_torch yet (ROADMAP 3.6)")


def train_fold(config: Dict, in_memory: bool = True,
               device="cuda") -> Trainer:
    """Train one fold on ``device`` and return its Trainer."""
    t0 = time()
    fold = C.get(config, "FOLD", 0)
    cfg = C.set_experiment_paths(C.normalise_config(config), fold=fold)
    _no_resume(cfg)

    console_and_file_logger(path=cfg["EXP_PATH"], log_lvl=logging.INFO)
    cfg = C.init_config(cfg, save=True)

    x_train, y_train, x_val, y_val = get_trainings_files(
        data_path=C.get(cfg, "DATA_PATH_SAX"),
        path_to_folds_df=C.get(cfg, "DF_FOLDS"), fold=fold)
    logging.info("SAX train CMR: %d, SAX train masks: %d", len(x_train),
                 len(y_train))
    logging.info("SAX val CMR: %d, SAX val masks: %d", len(x_val), len(y_val))

    batch_generator = DataGenerator(x_train, y_train, config=cfg,
                                    in_memory=in_memory)
    val_config = dict(cfg)
    val_config["AUGMENT"] = False          # no augmentation on validation data
    val_config["AUGMENT_GRID"] = False
    val_config["HIST_MATCHING"] = False
    validation_generator = DataGenerator(x_val, y_val, config=val_config,
                                         in_memory=in_memory)

    logging.info("Create model")
    trainer = Trainer(cfg, device=device)
    fold_root = cfg.get("FOLD_PATH", cfg["EXP_PATH"])
    with open(os.path.join(fold_root, "model_summary.txt"), "w") as fh:
        fh.write(model_summary(trainer.model) + "\n")

    fold_cfg = dict(cfg)
    fold_cfg["EXP_PATH"] = fold_root  # per-fold artifacts under f<k>/
    callbacks = get_callbacks(fold_cfg)
    logging.info("start training")
    trainer.fit_cached(batch_generator, val_gen=validation_generator,
                       epochs=C.get(cfg, "EPOCHS", 100), callbacks=callbacks)

    pred_fold(dict(cfg, EXP_PATH=fold_root), device=trainer.device)

    with open(os.path.join(fold_root, _FOLD_COMPLETE), "w") as fh:
        json.dump({"fold": fold, "epochs_run": len(trainer.history),
                   "epochs_target": int(C.get(cfg, "EPOCHS", 100) or 100),
                   "finished_at": time()}, fh)
    logging.info("Fold %s finished after %0.3f sec", fold, time() - t0)
    return trainer


def run_experiment(config: Dict, data_path: Optional[str] = None,
                   exp_path: Optional[str] = None, in_memory: bool = True,
                   device="cuda") -> str:
    """Loop FOLDS calling train_fold (ref: main, train_model.py:135-206).
    Returns the experiment path."""
    cfg = C.normalise_config(config)
    _no_resume(cfg)
    cfg["EXP_PATH"] = exp_path or C.timestamped_exp_path(cfg)
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
