"""Training callbacks — counterpart of ``cmrtpu/train/callbacks.py``
(equivalents of src/utils/KerasCallbacks.py), against the same trainer
protocol (``trainer.get_lr/set_lr``, ``trainer.stop_training``,
``trainer.train_state()``, ``trainer.serving_params``,
``trainer.switch_optimizer``):

  * ModelCheckpoint     best-only model.npz (the serving weights) and the
                        full train state, written in the background (ref:
                        :54-61)
  * ReduceLROnPlateau   factor/patience/cooldown/min_lr   (ref: :63-70)
  * EarlyStopping       patience on monitor               (ref: :105-111)
  * OptimizerChanger    early-stop -> switch to SGD, keep training (ref: :245-306)
  * PolynomialDecaySchedule, StepDecaySchedule, SGDRScheduler (ref: :80-87,
                        :154-164, :230-243, :308-384)
  * TensorBoardLogger   scalars incl. learning rate       (ref LRTensorBoard :167-174)
  * HistoryCSV          epoch metrics to history.csv
  * ImageWriter         pred-vs-gt overlays of fixed sample batches as
                        PNGs and TB images (ref CustomImageWritertf2
                        :386-536); ``feed_inputs_4_tensorboard`` draws the
                        batches (ref: :117-151)
  * WeightsSaver        weights every n epochs            (ref: :804-840)
  * TimeBudget          stop after a wall-clock budget

Over a process group every rank runs every callback on the same logs
(averaged over the ranks by the Trainer), so all decide alike; only rank 0
writes files (model.npz and state.pt, weights, history.csv, TensorBoard,
figures). Checkpoint saves turn synchronous under more than one process
and every rank waits at a barrier after each, so a rank that reads the
files next finds them whole.

The ImageWriter draws with matplotlib. Where it is missing (the card's
host), the writer warns once and writes nothing; training goes on.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np

from cmrtpu_torch import config as C
from cmrtpu_torch.parallel import mesh as M
from cmrtpu_torch.train import checkpoint as ckpt
from cmrtpu_torch.train.optimizers import polynomial_decay, sgdr_schedule
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
    """Best-only checkpoint: ``model_path/model.npz`` in the cmrtpu layout
    holding the serving weights (the EMA shadow when EMA is on), so cmrtpu
    and the port's Predictor both load it, and with ``save_full_state`` the
    whole train state in ``model_path/state.pt`` for a resume. With
    ``async_write`` the callback copies the state on the card and a
    background writer moves it to the host and writes it, overlapping the
    next epochs; ``on_train_end`` flushes before anyone reads the files. If
    no epoch ever improved the monitor, the final state is saved at train
    end so downstream consumers have weights to load."""

    def __init__(self, model_path: str, monitor: str = "loss",
                 mode: str = "min", save_full_state: bool = True,
                 async_write: bool = True):
        self.model_path = model_path
        self.monitor = monitor
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.save_full_state = save_full_state
        self._writer = ckpt.AsyncCheckpointWriter() \
            if async_write and not M.multi_process() else None
        self._saved = False
        self._warned_missing = False

    def _write(self, state):
        ckpt.save_weights(self.model_path, serving_weights(state))
        if self.save_full_state:
            ckpt.save_train_state(self.model_path, state)

    def _save(self, trainer):
        self._saved = True
        if self.save_full_state:
            state = trainer.train_state()
        else:
            # weights only: the optimizer's moments would never be read
            state = {"model": trainer.serving_params, "ema": None}
        if self._writer is not None:
            self._writer.submit(self._write, ckpt.device_snapshot(state))
        else:
            self._write(state)
            M.barrier(trainer.mesh)

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
        if self._writer is not None:
            self._writer.flush()


def serving_weights(state: Dict) -> Dict:
    """The state_dict that model.npz holds from a train state: the model's
    with the EMA shadow in place of the parameters when EMA is on."""
    return {**state["model"], **(state.get("ema") or {})}


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


class OptimizerChanger(EarlyStopping):
    """When the optimizer stops improving, switch to SGD and continue
    (ref: KerasCallbacks.py:245-306, idea arXiv:1712.07628)."""

    def __init__(self, monitor: str = "loss", patience: int = 15,
                 mode: str = "min"):
        super().__init__(monitor=monitor, patience=patience, mode=mode)
        self.changed = False

    def on_epoch_end(self, trainer, epoch, logs):
        if self.changed:
            return
        super().on_epoch_end(trainer, epoch, logs)
        if trainer.stop_training:
            trainer.stop_training = False
            self.changed = True
            logging.info("Epoch %d: switching optimizer to SGD for "
                         "fine-tuning", epoch + 1)
            trainer.switch_optimizer("sgd")


class PolynomialDecaySchedule(Callback):
    """lr = init * (1 - epoch/max)^power (ref: :80-87, :230-243)."""

    def __init__(self, max_epochs: int, init_alpha: float,
                 power: float = 2.0):
        self.max_epochs, self.init_alpha, self.power = \
            max_epochs, init_alpha, power

    def on_epoch_begin(self, trainer, epoch):
        trainer.set_lr(polynomial_decay(epoch, self.max_epochs,
                                        self.init_alpha, self.power))


class StepDecaySchedule(Callback):
    """lr = init * factor^floor((1+epoch)/drop_every)
    (ref: StepDecay, KerasCallbacks.py:154-164)."""

    def __init__(self, init_alpha: float = 0.01, factor: float = 0.25,
                 drop_every: int = 10):
        self.init_alpha, self.factor, self.drop_every = \
            init_alpha, factor, drop_every

    def on_epoch_begin(self, trainer, epoch):
        exponent = math.floor((1 + epoch) / self.drop_every)
        trainer.set_lr(float(self.init_alpha * (self.factor ** exponent)))


class SGDRScheduler(Callback):
    """Cosine annealing with warm restarts, stepped per epoch
    (ref: :308-384)."""

    def __init__(self, lr_min: float, lr_max: float, cycle_length: int = 10,
                 mult_factor: float = 2.0):
        self.lr_min, self.lr_max = lr_min, lr_max
        self.cycle_length, self.mult_factor = cycle_length, mult_factor

    def on_epoch_begin(self, trainer, epoch):
        trainer.set_lr(sgdr_schedule(epoch, self.lr_min, self.lr_max,
                                     self.cycle_length, self.mult_factor))


class TensorBoardLogger(Callback):
    """Scalars + learning rate into tfevents (ref LRTensorBoard :167-174)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.writer = None

    def on_train_begin(self, trainer):
        if not M.is_main_process():
            return
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
    each value printed with 6 significant digits (cmrtpu's format). With
    ``append`` an existing file keeps its rows and its header's columns (a
    resumed fold, whose file ``train_fold`` truncated first)."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self.keys: Optional[List[str]] = None
        self.append = append

    def on_epoch_end(self, trainer, epoch, logs):
        if not M.is_main_process():
            return
        ensure_dir(os.path.dirname(os.path.abspath(self.path)))
        row = dict(logs, lr=trainer.get_lr())
        if self.keys is None:
            if self.append and os.path.isfile(self.path):
                with open(self.path, newline="") as fh:
                    self.keys = next(csv.reader(fh))
            else:
                self.keys = ["epoch"] + sorted(row)
                with open(self.path, "w", newline="") as fh:
                    csv.writer(fh, lineterminator="\n").writerow(self.keys)
        with open(self.path, "a", newline="") as fh:
            csv.writer(fh, lineterminator="\n").writerow(
                [str(epoch)] + [f"{row.get(k, float('nan')):.6g}"
                                for k in self.keys[1:]])


class WeightsSaver(Callback):
    """The serving weights every n epochs (ref: WeightsSaver,
    src/utils/KerasCallbacks.py:804-840), in the background by default;
    per-epoch paths each get their own write (latest-wins collapses only
    writes to one path)."""

    def __init__(self, model_path: str, every_n_epochs: int = 5,
                 keep_per_epoch: bool = False, async_write: bool = True):
        self.model_path = model_path
        self.every_n_epochs = max(1, every_n_epochs)
        self.keep_per_epoch = keep_per_epoch
        self._writer = ckpt.AsyncCheckpointWriter() \
            if async_write and not M.multi_process() else None

    def on_epoch_end(self, trainer, epoch, logs):
        if (epoch + 1) % self.every_n_epochs:
            return
        path = (os.path.join(self.model_path, f"epoch_{epoch:04d}")
                if self.keep_per_epoch else self.model_path)
        if self._writer is not None:
            if self.keep_per_epoch:
                self._writer.flush()  # don't drop distinct per-epoch dumps
            self._writer.submit(ckpt.save_weights, path,
                                ckpt.device_snapshot(trainer.serving_params))
        else:
            ckpt.save_weights(path, trainer.serving_params)
            M.barrier(trainer.mesh)
        logging.info("Epoch %d: weights saved to %s", epoch + 1, path)

    def on_train_end(self, trainer):
        if self._writer is not None:
            self._writer.flush()


class ImageWriter(Callback):
    """Pred-vs-gt overlays of fixed sample batches every ``frequency``
    epochs (epoch 0 first), written as
    ``<image_dir>/epoch{e:04d}_{name}.png`` and, with ``to_tensorboard``,
    as TB image summaries under ``tb_dir`` (ref CustomImageWritertf2
    :386-536 / ImageSaver :661). ``sample_batches`` are host numpy
    (name, x, y) triples; the whole x is predicted, the first ``samples``
    rows are drawn, a multi-head prediction as its heads' channels
    concatenated in HEADS order. A failed render warns once, then logs at
    debug. Without matplotlib the writer warns once, naming it, and runs
    no forward from then on."""

    def __init__(self, image_dir: str, sample_batches: List,
                 frequency: int = 2, samples: int = 4,
                 to_tensorboard: bool = False, tb_dir: Optional[str] = None):
        self.image_dir = image_dir
        self.sample_batches = sample_batches
        self.frequency = max(1, frequency)
        self.samples = samples
        self.to_tensorboard = to_tensorboard
        self.tb_dir = tb_dir or image_dir
        self._writer = None
        self._warned = False
        self._disabled = False

    def _renderer(self):
        """``save_prediction_overlays``, or None (with the one warning)
        where matplotlib does not import."""
        try:
            from cmrtpu_torch.visualization.visualize import (
                pyplot, save_prediction_overlays)
            pyplot()
        except ImportError as e:
            self._disabled = True
            logging.warning(
                "SAVE_LEARNING_PROGRESS_AS_PNG/_AS_TF: matplotlib does not "
                "import (%s); no learning-progress images are written, "
                "training goes on", e)
            return None
        return save_prediction_overlays

    def on_epoch_end(self, trainer, epoch, logs):
        if epoch % self.frequency or self._disabled \
                or not M.is_main_process():
            return
        render = self._renderer()
        if render is None:
            return
        for name, x, y in self.sample_batches:
            preds = trainer.predict(x)
            if isinstance(preds, dict):
                heads = [h[0] for h in (trainer.config.get("HEADS") or ())] \
                    or sorted(preds)
                preds = np.concatenate([np.asarray(preds[h]) for h in heads],
                                       axis=-1)
            preds = np.asarray(preds)
            out = os.path.join(self.image_dir, f"epoch{epoch:04d}_{name}.png")
            try:
                render(x[:self.samples], y[:self.samples],
                       preds[:self.samples], out)
                if self.to_tensorboard:
                    self._tb_image(name, out, epoch)
            except Exception as e:
                level = logging.DEBUG if self._warned else logging.WARNING
                logging.log(level, "learning-progress image rendering failed"
                            " (batch '%s', epoch %d): %s", name, epoch, e)
                self._warned = True

    def _tb_image(self, name: str, png_path: str, epoch: int) -> None:
        import matplotlib.image as mpimg
        from cmrtpu_torch.utils.tfevents import EventWriter
        if self._writer is None:
            self._writer = EventWriter(self.tb_dir, filename_suffix=".images")
        rgb = (mpimg.imread(png_path)[..., :3] * 255).astype(np.uint8)
        self._writer.add_image(name, rgb, epoch)
        self._writer.flush()

    def on_train_end(self, trainer):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TimeBudget(Callback):
    """Stop training once the wall clock since on_train_begin reaches
    ``budget_s`` seconds (the set-up of the first epoch counts)."""

    def __init__(self, budget_s: float):
        self.budget_s = float(budget_s)
        self._t0 = None

    def on_train_begin(self, trainer):
        self._t0 = time.time()

    def on_epoch_end(self, trainer, epoch, logs):
        elapsed = time.time() - self._t0
        if elapsed >= self.budget_s:
            logging.info("TimeBudget: %.1fs >= %.1fs after epoch %d — "
                         "stopping", elapsed, self.budget_s, epoch + 1)
            trainer.stop_training = True


def get_callbacks(config: Dict, sample_batches: Optional[List] = None,
                  use_optimizer_changer: bool = False) -> List[Callback]:
    """The reference callback set from config (ref: get_callbacks,
    src/utils/KerasCallbacks.py:20-115), in cmrtpu's order; an ImageWriter
    over ``sample_batches`` when SAVE_LEARNING_PROGRESS_AS_PNG or _AS_TF
    asks for one."""
    model_path = C.get(config, "MODEL_PATH", "temp/models")
    tb_path = C.get(config, "TENSORBOARD_PATH", "temp/tf_log")
    monitor = C.get(config, "MONITOR_FUNCTION", "loss")
    mode = C.get(config, "MONITOR_MODE", "min")
    cbs: List[Callback] = [
        ModelCheckpoint(model_path,
                        monitor=C.get(config, "SAVE_MODEL_FUNCTION", "loss"),
                        mode=C.get(config, "SAVE_MODEL_MODE", "min")),
        ReduceLROnPlateau(
            monitor=monitor, factor=C.get(config, "DECAY_FACTOR", 0.5),
            patience=C.get(config, "REDUCE_LR_ON_PLATEAU_PATIENCE", 5),
            cooldown=2, mode=mode, min_lr=C.get(config, "MIN_LR", 1e-12)),
        TensorBoardLogger(tb_path),
        HistoryCSV(os.path.join(C.get(config, "EXP_PATH", "tmp"),
                                "history.csv")),
    ]
    if C.get(config, "POLY_LR_DECAY", False):
        cbs.append(PolynomialDecaySchedule(
            C.get(config, "EPOCHS", 100), C.get(config, "LEARNING_RATE",
                                                1e-4)))
    if use_optimizer_changer:
        cbs.append(OptimizerChanger(monitor=monitor, patience=15, mode=mode))
    else:
        cbs.append(EarlyStopping(
            monitor=monitor,
            patience=C.get(config, "EARLY_STOPPING_PATIENCE", 25), mode=mode))
    to_tb = C.get(config, "SAVE_LEARNING_PROGRESS_AS_TF", False)
    if sample_batches and (
            C.get(config, "SAVE_LEARNING_PROGRESS_AS_PNG", False) or to_tb):
        cbs.append(ImageWriter(
            os.path.join(C.get(config, "EXP_PATH", "tmp"), "figures"),
            sample_batches,
            frequency=C.get(config, "SAVE_LEARNING_PROGRESS_FREQUENCY", 2),
            to_tensorboard=to_tb, tb_dir=tb_path))
    return cbs


def feed_inputs_4_tensorboard(config: Dict, batch_generator=None,
                              validation_generator=None,
                              samples: int = 4) -> List:
    """Fixed sample batches for the ImageWriter, the first
    min(BATCHSIZE, ``samples``) rows of batch 0 of each generator given
    (ref: feed_inputs_4_tensorboard, src/utils/KerasCallbacks.py:117-151):
    [("gen_train", x, y), ("gen_val", x, y)] as host numpy."""
    samples = min(C.get(config, "BATCHSIZE", 32), samples)
    feeds: List = []
    for name, gen in (("gen_train", batch_generator),
                      ("gen_val", validation_generator)):
        if gen is None:
            continue
        x, y = gen[0]
        feeds.append((name, host_numpy(x)[:samples],
                      None if y is None else host_numpy(y)[:samples]))
    logging.info("feed 4 Tensorboard is ready")
    return feeds


def host_numpy(a) -> np.ndarray:
    """A batch (a tensor on any device, or an array) as host numpy."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def seed_best_from_history(cb: ModelCheckpoint, history) -> None:
    """Seed a fresh ModelCheckpoint's ``best`` from prior epoch rows (dicts
    of monitor -> value), so the first epoch of a continued fit cannot
    "improve" on ±inf and overwrite a better earlier checkpoint. NaN epochs
    are skipped: min()/max() would propagate a NaN, and every later
    comparison with it is False, which would switch checkpointing off."""
    vals = [float(r[cb.monitor]) for r in history if cb.monitor in r]
    vals = [v for v in vals if not math.isnan(v)]
    if vals:
        cb.best = min(vals) if cb.mode == "min" else max(vals)


def finetune_with_sgd(trainer, train_data, val_data=None,
                      initial_epoch: int = 0, epochs: Optional[int] = None):
    """Fine-tune a trained model with plain SGD: switch the optimizer (fresh
    state) and continue fitting from ``initial_epoch`` with the standard
    callback set (ref: finetune_with_SGD, src/utils/KerasCallbacks.py:
    280-306). The new ModelCheckpoint starts from the best of
    ``trainer.history``, and an existing model.npz is not replaced by the
    never-improved fallback."""
    trainer.switch_optimizer("sgd")
    cbs = get_callbacks(trainer.config)
    for cb in cbs:
        if isinstance(cb, ModelCheckpoint):
            seed_best_from_history(cb, trainer.history)
            if os.path.exists(os.path.join(cb.model_path, ckpt.WEIGHTS_NAME)):
                cb._saved = True
    return trainer.fit(train_data, val_data, epochs=epochs,
                       initial_epoch=initial_epoch, callbacks=cbs)
