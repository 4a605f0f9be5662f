"""cmrtpu_torch's LR schedules and callbacks against cmrtpu on the CPU.

* ``polynomial_decay`` and ``sgdr_schedule`` equal cmrtpu's functions.
* Over a simulated fold (logs that improve, then plateau, then diverge),
  each package's ``get_callbacks`` set drives its own Trainer; the
  learning rates each epoch starts with are equal (both store a float32
  hyperparameter), as are the epochs at which EarlyStopping stops and
  OptimizerChanger switches to sgd.
* WeightsSaver's paths and contents, TimeBudget, ``seed_best_from_history``
  with NaN rows, and ``finetune_with_sgd`` over host batches.
"""

import math
import os

import numpy as np
import pytest
import torch

from cmrtpu.train import callbacks as JCB
from cmrtpu.train import optimizers as JO
from cmrtpu.train.trainer import Trainer as JaxTrainer
from cmrtpu_torch.train import callbacks as CB
from cmrtpu_torch.train import optimizers as O
from cmrtpu_torch.train.checkpoint import flax_to_state_dict, load_weights
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG

torch.set_num_threads(1)


@pytest.mark.parametrize("epoch,max_epochs,power", [
    (0, 100, 2.0), (25, 100, 1.0), (37, 50, 2.0), (50, 50, 2.0),
    (60, 50, 2.0), (3, 7, 0.5)])
def test_polynomial_decay_equals_cmrtpu(epoch, max_epochs, power):
    assert O.polynomial_decay(epoch, max_epochs, 1e-3, power) == \
        JO.polynomial_decay(epoch, max_epochs, 1e-3, power)


@pytest.mark.parametrize("cycle,mult", [(10.0, 2.0), (4.0, 1.0), (3.0, 1.5)])
def test_sgdr_schedule_equals_cmrtpu(cycle, mult):
    for it in range(0, 80, 3):
        assert O.sgdr_schedule(it, 1e-5, 1e-2, cycle, mult) == \
            JO.sgdr_schedule(it, 1e-5, 1e-2, cycle, mult)


def _fold_logs(epochs=40):
    """val_loss improves for 8 epochs, plateaus (with tiny gains below
    ReduceLROnPlateau's min_delta), then worsens."""
    out = []
    for e in range(epochs):
        if e < 8:
            v = 1.0 - 0.05 * e
        elif e < 25:
            v = 0.6 - 1e-5 * (e - 8)
        else:
            v = 0.6 + 0.01 * (e - 25)
        out.append({"loss": v + 0.1, "val_loss": v})
    return out


def _drive(trainer, cbs, logs):
    """on_epoch_begin/end of the lr-moving callbacks; returns the lr each
    epoch started with and the epoch the run stopped after, if any."""
    lrs, stop = [], None
    for cb in cbs:
        cb.on_train_begin(trainer)
    for epoch, row in enumerate(logs):
        for cb in cbs:
            cb.on_epoch_begin(trainer, epoch)
        lrs.append(trainer.get_lr())
        for cb in cbs:
            cb.on_epoch_end(trainer, epoch, dict(row))
        if trainer.stop_training:
            stop = epoch
            break
    return lrs, stop


def _lr_callbacks(cbs, kinds):
    return [cb for cb in cbs if isinstance(cb, kinds)]


@pytest.mark.parametrize("extra,changer", [
    ({"POLY_LR_DECAY": True, "EPOCHS": 40}, False),
    ({"REDUCE_LR_ON_PLATEAU_PATIENCE": 3, "EARLY_STOPPING_PATIENCE": 9},
     False),
    ({"REDUCE_LR_ON_PLATEAU_PATIENCE": 4}, True),
], ids=["poly", "plateau-earlystop", "optimizer-changer"])
def test_fold_lr_sequence_equals_cmrtpu(extra, changer, tmp_path):
    cfg = dict(CFG, MONITOR_FUNCTION="val_loss", LEARNING_RATE=1e-3,
               EXP_PATH=str(tmp_path), **extra)
    logs = _fold_logs()
    kinds = (CB.ReduceLROnPlateau, CB.PolynomialDecaySchedule,
             CB.EarlyStopping)
    jkinds = (JCB.ReduceLROnPlateau, JCB.PolynomialDecaySchedule,
              JCB.EarlyStopping)
    port = Trainer(cfg, device="cpu")
    ref = JaxTrainer(cfg)
    got = _drive(port, _lr_callbacks(
        CB.get_callbacks(cfg, use_optimizer_changer=changer), kinds), logs)
    want = _drive(ref, _lr_callbacks(
        JCB.get_callbacks(cfg, use_optimizer_changer=changer), jkinds), logs)
    assert got == want
    assert len(set(got[0])) > 1  # the lr moved
    assert port.optimizer_name == ref.optimizer_name == \
        ("sgd" if changer else "adam")


def test_optimizer_changer_switches_once():
    trainer = Trainer(CFG, device="cpu")
    cb = CB.OptimizerChanger(monitor="val_loss", patience=2)
    for epoch, v in enumerate([0.5, 0.6, 0.7, 0.8, 0.9, 1.0]):
        cb.on_epoch_end(trainer, epoch, {"val_loss": v})
        assert not trainer.stop_training
        if epoch == 1:
            assert trainer.optimizer_name == "adam"
    assert cb.changed and trainer.optimizer_name == "sgd"
    assert trainer.state.optimizer is trainer.optimizer
    assert trainer.get_lr() == pytest.approx(CFG.get("LEARNING_RATE", 1e-4))


def _step(trainer):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 1)).astype(np.float32))
    y = torch.zeros(4, 32, 32, 2)
    y[:, 8:12, 8:12, 0] = 1.0
    trainer.state.train_step(x, y)
    return x, y


@pytest.mark.parametrize("keep,async_write", [(True, True), (False, True),
                                              (True, False)])
def test_weights_saver_paths(tmp_path, keep, async_write):
    trainer = Trainer(dict(CFG, EMA=0.5), device="cpu")
    cb = CB.WeightsSaver(str(tmp_path), every_n_epochs=2,
                         keep_per_epoch=keep, async_write=async_write)
    saved = {}
    for epoch in range(5):
        _step(trainer)
        cb.on_epoch_end(trainer, epoch, {})
        if (epoch + 1) % 2 == 0:
            saved[epoch] = {k: v.clone()
                            for k, v in trainer.serving_params.items()}
    cb.on_train_end(trainer)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, fs in os.walk(tmp_path) for f in fs)
    if keep:
        assert files == ["epoch_0001/model.npz", "epoch_0003/model.npz"]
    else:
        assert files == ["model.npz"]
    for epoch in ((1, 3) if keep else (3,)):
        path = os.path.join(tmp_path, f"epoch_{epoch:04d}") if keep \
            else str(tmp_path)
        got = flax_to_state_dict(*load_weights(path))
        for name, tensor in got.items():
            assert torch.equal(tensor, saved[epoch][name]), name


@pytest.mark.parametrize("budget,stops", [(0.0, True), (3600.0, False)])
def test_time_budget(budget, stops):
    trainer = Trainer(CFG, device="cpu")
    cb = CB.TimeBudget(budget)
    cb.on_train_begin(trainer)
    cb.on_epoch_end(trainer, 0, {})
    assert trainer.stop_training is stops


@pytest.mark.parametrize("mode", ["min", "max"])
def test_seed_best_from_history_skips_nan(mode, tmp_path):
    rows = [{"val_loss": 0.5}, {"val_loss": float("nan")},
            {"val_loss": 0.3}, {"loss": 0.1}, {"val_loss": 0.7}]
    got = CB.ModelCheckpoint(str(tmp_path), monitor="val_loss", mode=mode)
    want = JCB.ModelCheckpoint(str(tmp_path), monitor="val_loss", mode=mode,
                               async_write=False)
    CB.seed_best_from_history(got, rows)
    JCB.seed_best_from_history(want, rows)
    assert got.best == want.best == (0.3 if mode == "min" else 0.7)
    only_nan = CB.ModelCheckpoint(str(tmp_path), monitor="val_loss")
    CB.seed_best_from_history(only_nan, [{"val_loss": float("nan")}])
    assert only_nan.best == math.inf


def test_finetune_with_sgd_keeps_the_better_checkpoint(tmp_path):
    cfg = dict(CFG, MODEL_PATH=str(tmp_path / "model"),
               TENSORBOARD_PATH=str(tmp_path / "tb"), EXP_PATH=str(tmp_path),
               SAVE_MODEL_FUNCTION="val_loss", MONITOR_FUNCTION="val_loss",
               LEARNING_RATE=1e-3)
    trainer = Trainer(cfg, device="cpu")
    x, y = _step(trainer)
    CB.ModelCheckpoint(cfg["MODEL_PATH"], monitor="val_loss",
                       async_write=False)._save(trainer)
    before = open(tmp_path / "model" / "model.npz", "rb").read()
    trainer.history = [{"val_loss": -1.0}]  # a best no SGD epoch can beat
    batches = [(x.numpy(), y.numpy())] * 2
    history = CB.finetune_with_sgd(trainer, batches, batches, initial_epoch=1,
                                   epochs=3)
    assert trainer.optimizer_name == "sgd"
    assert len(history) == 3 and all(np.isfinite(h["val_loss"])
                                     for h in history[1:])
    assert open(tmp_path / "model" / "model.npz", "rb").read() == before
    rows = open(tmp_path / "history.csv").read().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2"]
