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

import builtins
import glob
import logging
import math
import os
import struct

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


# -- the learning-progress ImageWriter ----------------------------------------

class _FakeTrainer:
    """The ImageWriter's view of a trainer: ``config`` and ``predict``,
    here fixed arrays (per head for a HEADS config) counted per call."""

    def __init__(self, config, n, hw=24):
        self.config = config
        self.calls = 0
        rng = np.random.default_rng(3)
        heads = config.get("HEADS")
        self._out = {h[0]: rng.random((n, hw, hw, h[1])).astype(np.float32)
                     for h in heads} if heads else \
            rng.random((n, hw, hw, 2)).astype(np.float32)

    def predict(self, x):
        self.calls += 1
        return self._out


def _batches(n=6, hw=24, channels=2):
    rng = np.random.default_rng(0)
    return [(name, rng.normal(size=(n, hw, hw, 1)).astype(np.float32),
             (rng.random((n, hw, hw, channels)) > 0.8).astype(np.float32))
            for name in ("train", "val")]


def _event_payloads(tb_dir):
    """Each record of the image event file with the event's wall time
    (its first field, 9 bytes) cut off."""
    (path,) = glob.glob(os.path.join(tb_dir, "*.images"))
    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        out.append(data[i + 12:i + 12 + n][9:])
        i += 12 + n + 4
    return out


@pytest.mark.parametrize("heads", [None, [["msk", 2, "sigmoid"],
                                          ["seg", 4, "softmax"]]],
                         ids=["one-head", "multihead"])
def test_image_writer_writes_as_cmrtpu(tmp_path, heads):
    """PNGs and TB image events on the same epochs (frequency 2: epochs
    0 and 2 of 0-3), byte for byte; a multi-head prediction drawn as the
    heads' channels concatenated in HEADS order (the dict's sorted order
    is the other one)."""
    cfg = {"HEADS": heads} if heads else {}
    batches = _batches(n=2, channels=6 if heads else 2)
    written = {}
    for name, mod in (("ref", JCB), ("got", CB)):
        out = tmp_path / name
        writer = mod.ImageWriter(str(out / "figures"), batches, frequency=2,
                                 to_tensorboard=True, tb_dir=str(out / "tb"))
        trainer = _FakeTrainer(cfg, 2)
        for epoch in range(4):
            writer.on_epoch_end(trainer, epoch, {})
        writer.on_train_end(trainer)
        assert trainer.calls == 2 * len(batches)
        written[name] = {os.path.basename(p): open(p, "rb").read()
                         for p in glob.glob(str(out / "figures" / "*.png"))}
        written[name + "_tb"] = _event_payloads(str(out / "tb"))
    assert sorted(written["got"]) == [
        f"epoch{e:04d}_{b}.png" for e in (0, 2) for b in ("train", "val")]
    assert written["got"] == written["ref"]
    assert len(written["got_tb"]) == 1 + 4
    assert written["got_tb"] == written["ref_tb"]


def test_feed_inputs_4_tensorboard_matches_cmrtpu(tmp_path):
    from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
    from cmrtpu_torch.pipeline.generator import DataGenerator
    from test_torch_streaming import _write_slices

    xs, ys = _write_slices(tmp_path, n=8)
    cfg = dict(CFG, DIM=[24, 24], BATCHSIZE=4, SHUFFLE=False)
    feeds = {}
    for name, gen in (("ref", JaxGenerator), ("got", DataGenerator)):
        kwargs = {"device": "cpu"} if name == "got" else {}
        train = gen(xs[:4], ys[:4], config=cfg, **kwargs)
        val = gen(xs[4:], ys[4:], config=cfg, **kwargs)
        feeds[name] = (JCB if name == "ref" else CB).feed_inputs_4_tensorboard(
            dict(cfg, BATCHSIZE=3), train, val)
    assert [f[0] for f in feeds["got"]] == ["gen_train", "gen_val"]
    for (rn, rx, ry), (gn, gx, gy) in zip(feeds["ref"], feeds["got"]):
        assert isinstance(gx, np.ndarray) and gx.shape == rx.shape \
            == (3, 24, 24, 1) and gy.shape == ry.shape == (3, 24, 24, 2)
        np.testing.assert_allclose(gx, rx, atol=1e-6)
        np.testing.assert_allclose(gy, ry, atol=1e-5)


def test_image_writer_without_matplotlib(tmp_path, monkeypatch, caplog):
    """The card has no matplotlib: one warning naming it, no forward, no
    file, at every image epoch; training goes on."""
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    writer = CB.ImageWriter(str(tmp_path / "figures"), _batches(),
                            frequency=1, to_tensorboard=True,
                            tb_dir=str(tmp_path / "tb"))
    trainer = _FakeTrainer({}, 6)
    with caplog.at_level(logging.DEBUG):
        for epoch in range(4):
            writer.on_epoch_end(trainer, epoch, {})
        writer.on_train_end(trainer)
    warned = [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert len(warned) == 1 and "matplotlib" in warned[0].getMessage()
    assert trainer.calls == 0
    assert not os.path.exists(tmp_path / "figures")
    assert not os.path.exists(tmp_path / "tb")


def test_get_callbacks_adds_the_image_writer_as_cmrtpu(tmp_path):
    cfg = dict(CFG, EXP_PATH=str(tmp_path), MODEL_PATH=str(tmp_path / "m"),
               TENSORBOARD_PATH=str(tmp_path / "tb"),
               SAVE_LEARNING_PROGRESS_AS_PNG=True,
               SAVE_LEARNING_PROGRESS_FREQUENCY=3)
    batches = _batches()
    for extra, batch_arg in (({}, batches), ({}, None),
                             ({"SAVE_LEARNING_PROGRESS_AS_PNG": False},
                              batches),
                             ({"SAVE_LEARNING_PROGRESS_AS_PNG": False,
                               "SAVE_LEARNING_PROGRESS_AS_TF": True},
                              batches)):
        got = CB.get_callbacks(dict(cfg, **extra), sample_batches=batch_arg)
        ref = JCB.get_callbacks(dict(cfg, **extra), sample_batches=batch_arg)
        assert [type(c).__name__ for c in got] == \
            [type(c).__name__ for c in ref]
        for g, r in zip(got, ref):
            if isinstance(g, CB.ImageWriter):
                assert (g.image_dir, g.frequency, g.to_tensorboard,
                        g.tb_dir) == (r.image_dir, r.frequency,
                                      r.to_tensorboard, r.tb_dir)


def test_train_fold_writes_progress_images(tmp_path):
    """A fold with SAVE_LEARNING_PROGRESS_AS_PNG and _AS_TF writes its
    sample batches' overlays (train and val) at every image epoch and the
    TB image events beside the scalars."""
    from cmrtpu_torch.train.fold import run_experiment
    from test_torch_train import _write_dataset

    data = _write_dataset(str(tmp_path / "data"))
    exp = run_experiment(dict(CFG, SAVE_LEARNING_PROGRESS_AS_PNG=True,
                              SAVE_LEARNING_PROGRESS_AS_TF=True,
                              SAVE_LEARNING_PROGRESS_FREQUENCY=1,
                              AUGMENT=True, AUGMENT_PROB=0.5),
                         data_path=data, exp_path=str(tmp_path / "exp"),
                         device="cpu")
    figures = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(exp, "f0", "figures", "*.png")))
    assert figures == [f"epoch{e:04d}_{b}.png" for e in (0, 1)
                       for b in ("train", "val")]
    tb = glob.glob(os.path.join(exp, "**", "*.images"), recursive=True)
    assert len(tb) == 1 and len(_event_payloads(os.path.dirname(tb[0]))) \
        == 1 + 4
