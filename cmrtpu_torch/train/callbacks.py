"""Training callbacks — counterpart of ``cmrtpu/train/callbacks.py``
(equivalents of src/utils/KerasCallbacks.py), against the same trainer
protocol (``trainer.get_lr/set_lr``, ``trainer.stop_training``,
``trainer.model``):

  * ModelCheckpoint     best-only weights-only model.npz  (ref: :54-61)
  * ReduceLROnPlateau   factor/patience/cooldown/min_lr   (ref: :63-70)
  * EarlyStopping       patience on monitor               (ref: :105-111)
  * TensorBoardLogger   scalars incl. learning rate       (ref LRTensorBoard :167-174)
  * HistoryCSV          epoch metrics to history.csv

Checkpoints are written synchronously. Not ported yet (ROADMAP 3.6): the
learning-progress ImageWriter (it needs matplotlib), the LR schedules,
OptimizerChanger, WeightsSaver, TimeBudget and full-state checkpoints.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from typing import Dict, List, Optional

from cmrtpu_torch import config as C
from cmrtpu_torch.train import checkpoint as ckpt
from cmrtpu_torch.utils.io_utils import ensure_dir


class Callback:
    def on_train_begin(self, trainer):
        pass

    def on_epoch_begin(self, trainer, epoch: int):
        pass

    def on_epoch_end(self, trainer, epoch: int, logs: Dict[str, float]):
        pass

    def on_train_end(self, trainer):
        pass


def _improved(current: float, best: float, mode: str) -> bool:
    if math.isnan(current):
        return False
    return current < best if mode == "min" else current > best


class ModelCheckpoint(Callback):
    """Best-only weights-only checkpoint: ``model_path/model.npz`` in the
    cmrtpu layout, so cmrtpu and the port's Predictor both load it. If no
    epoch ever improved the monitor, the final weights are saved at train
    end so downstream consumers have weights to load."""

    def __init__(self, model_path: str, monitor: str = "loss",
                 mode: str = "min"):
        self.model_path = model_path
        self.monitor = monitor
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self._saved = False
        self._warned_missing = False

    def _save(self, trainer):
        self._saved = True
        ckpt.save_weights(self.model_path, trainer.model)

    def on_epoch_end(self, trainer, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            if not self._warned_missing:
                self._warned_missing = True
                logging.warning(
                    "ModelCheckpoint: monitor '%s' not in epoch logs %s — "
                    "no best-only checkpoints will be written (is the "
                    "validation set empty?)", self.monitor, sorted(logs))
            return
        if _improved(current, self.best, self.mode):
            logging.info("Epoch %d: %s improved from %.5f to %.5f, saving "
                         "model", epoch + 1, self.monitor, self.best, current)
            self.best = current
            self._save(trainer)

    def on_train_end(self, trainer):
        if not self._saved:
            logging.warning(
                "ModelCheckpoint: no epoch ever improved monitor '%s'; "
                "saving the final training state as a fallback", self.monitor)
            self._save(trainer)


class ReduceLROnPlateau(Callback):
    """keras-parity plateau scheduler: cooldown=2 (ref: :63-70)."""

    def __init__(self, monitor: str = "loss", factor: float = 0.5,
                 patience: int = 5, cooldown: int = 2, min_lr: float = 1e-12,
                 mode: str = "min", min_delta: float = 1e-4):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.cooldown, self.min_lr, self.mode = cooldown, min_lr, mode
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0
        self.cooldown_counter = 0

    def _improved(self, current):
        if self.mode == "min":
            return current < self.best - self.min_delta
        return current > self.best + self.min_delta

    def on_epoch_end(self, trainer, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(current):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old_lr = trainer.get_lr()
                if old_lr > self.min_lr:
                    new_lr = max(old_lr * self.factor, self.min_lr)
                    trainer.set_lr(new_lr)
                    logging.info("Epoch %d: ReduceLROnPlateau reducing lr "
                                 "to %.3e", epoch + 1, new_lr)
                self.cooldown_counter = self.cooldown
                self.wait = 0


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", patience: int = 25,
                 mode: str = "min"):
        self.monitor, self.patience, self.mode = monitor, patience, mode
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, trainer, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            return
        if _improved(current, self.best, self.mode):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                logging.info("Epoch %d: early stopping (%s)", epoch + 1,
                             self.monitor)
                trainer.stop_training = True


class TensorBoardLogger(Callback):
    """Scalars + learning rate into tfevents (ref LRTensorBoard :167-174)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.writer = None

    def on_train_begin(self, trainer):
        from cmrtpu_torch.utils.tfevents import EventWriter
        self.writer = EventWriter(self.log_dir)

    def on_epoch_end(self, trainer, epoch, logs):
        if self.writer is None:
            return
        for tag, value in logs.items():
            self.writer.add_scalar(f"epoch_{tag}", float(value), epoch)
        self.writer.add_scalar("epoch_lr", trainer.get_lr(), epoch)
        self.writer.flush()

    def on_train_end(self, trainer):
        if self.writer is not None:
            self.writer.close()


class HistoryCSV(Callback):
    """One row per epoch: ``epoch`` then the sorted log keys and ``lr``,
    each value printed with 6 significant digits (cmrtpu's format)."""

    def __init__(self, path: str):
        self.path = path
        self.keys: Optional[List[str]] = None

    def on_epoch_end(self, trainer, epoch, logs):
        ensure_dir(os.path.dirname(os.path.abspath(self.path)))
        row = dict(logs, lr=trainer.get_lr())
        if self.keys is None:
            self.keys = ["epoch"] + sorted(row)
            with open(self.path, "w", newline="") as fh:
                csv.writer(fh, lineterminator="\n").writerow(self.keys)
        with open(self.path, "a", newline="") as fh:
            csv.writer(fh, lineterminator="\n").writerow(
                [str(epoch)] + [f"{row.get(k, float('nan')):.6g}"
                                for k in self.keys[1:]])


def get_callbacks(config: Dict) -> List[Callback]:
    """The reference callback set from config (ref: get_callbacks,
    src/utils/KerasCallbacks.py:20-115), in cmrtpu's order."""
    if C.get(config, "POLY_LR_DECAY", False):
        raise NotImplementedError(
            "the polynomial LR schedule (POLY_LR_DECAY) is not ported to "
            "cmrtpu_torch yet (ROADMAP 3.6)")
    model_path = C.get(config, "MODEL_PATH", "temp/models")
    tb_path = C.get(config, "TENSORBOARD_PATH", "temp/tf_log")
    cbs: List[Callback] = [
        ModelCheckpoint(model_path,
                        monitor=C.get(config, "SAVE_MODEL_FUNCTION", "loss"),
                        mode=C.get(config, "SAVE_MODEL_MODE", "min")),
        ReduceLROnPlateau(
            monitor=C.get(config, "MONITOR_FUNCTION", "loss"),
            factor=C.get(config, "DECAY_FACTOR", 0.5),
            patience=C.get(config, "REDUCE_LR_ON_PLATEAU_PATIENCE", 5),
            cooldown=2,
            mode=C.get(config, "MONITOR_MODE", "min"),
            min_lr=C.get(config, "MIN_LR", 1e-12)),
        TensorBoardLogger(tb_path),
        HistoryCSV(os.path.join(C.get(config, "EXP_PATH", "tmp"),
                                "history.csv")),
        EarlyStopping(monitor=C.get(config, "MONITOR_FUNCTION", "loss"),
                      patience=C.get(config, "EARLY_STOPPING_PATIENCE", 25),
                      mode=C.get(config, "MONITOR_MODE", "min")),
    ]
    if (C.get(config, "SAVE_LEARNING_PROGRESS_AS_PNG", False)
            or C.get(config, "SAVE_LEARNING_PROGRESS_AS_TF", False)):
        logging.warning(
            "SAVE_LEARNING_PROGRESS_AS_PNG/_AS_TF: the learning-progress "
            "ImageWriter is not ported to cmrtpu_torch yet (ROADMAP 3.6); "
            "no progress images are written")
    return cbs
