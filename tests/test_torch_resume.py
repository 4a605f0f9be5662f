"""cmrtpu_torch's full-state resume (RESUME, ``cli.train -resume``) on the
CPU, against cmrtpu and against the port's own uninterrupted run.

* The counterparts of cmrtpu's resume tests (tests/test_end_to_end.py):
  a resumed fold continues its epoch count with history.csv contiguous; a
  completed fold is skipped unless EPOCHS rises; no state on disk trains
  from scratch; ``run_experiment`` re-enters the latest run, or the
  config's EXP_PATH when it lies under the experiment's root.
* A resumed ``run_experiment`` (2 epochs, then RESUME to 3) with EMA on
  within rel 1e-4 of cmrtpu's resumed run, from cmrtpu's initial weights
  with AUGMENT off and dropout 0; its model.npz holds the shadow.
* With SHUFFLE false, augmentation and dropout on, a run resumed from its
  best checkpoint equals the uninterrupted run exactly (every history value
  and the final weights); a control that restores no generator states
  does not.
* The saved state restores bit for bit (weights, moments, step, lr, EMA
  shadow, generators), a state saved after the switch to sgd restores into
  sgd, AGC, EPSILON and MOMENTUM come from the resumed run's config, and a
  third ``-resume`` call with the same EPOCHS changes no file.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import cmrtpu.train.trainer as jax_trainer
from cmrtpu.models.unet import init_variables
from cmrtpu.train.fold import run_experiment as jax_run_experiment
from cmrtpu_torch.cli.train import main as train_main
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.train import fold as F
from cmrtpu_torch.train import trainer as port_trainer
from cmrtpu_torch.train.callbacks import ModelCheckpoint
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict, load_weights,
                                           restore_train_state)
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG, _history, _write_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("resume") / "data"))


def _fold_cfg(data, exp, **extra):
    cfg = dict(CFG, EXP_PATH=exp, FOLD=0, CC_FILTER=False, **extra)
    cfg["DATA_PATH_SAX"] = os.path.join(data, "2D")
    cfg["DF_FOLDS"] = os.path.join(data, "df_kfold.csv")
    cfg["DATA_PATH_ORIG"] = os.path.join(data, "original")
    return cfg


def _hist_path(exp):
    return os.path.join(exp, "f0", "history.csv")


def test_train_fold_resume_continues(data, tmp_path):
    cfg = _fold_cfg(data, str(tmp_path / "run"), EPOCHS=2)
    first = F.train_fold(cfg, device="cpu")
    before = open(_hist_path(cfg["EXP_PATH"])).read().splitlines()
    assert len(before) == 3
    again = F.train_fold(dict(cfg, EPOCHS=4, RESUME=True), device="cpu")
    assert again.state.step > first.state.step
    rows = _history(_hist_path(cfg["EXP_PATH"]))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    after = open(_hist_path(cfg["EXP_PATH"])).read().splitlines()
    # the rows before the restore point stay byte for byte
    restored = first.state.step // (9 // CFG["BATCHSIZE"])
    assert after[:1 + restored] == before[:1 + restored]
    with open(os.path.join(cfg["EXP_PATH"], "f0",
                           "fold_complete.json")) as fh:
        assert json.load(fh)["epochs_target"] == 4


def test_train_fold_resume_skips_completed_fold(data, tmp_path):
    cfg = _fold_cfg(data, str(tmp_path / "run"), EPOCHS=2)
    assert F.train_fold(cfg, device="cpu") is not None
    before = open(_hist_path(cfg["EXP_PATH"])).read()
    assert F.train_fold(dict(cfg, RESUME=True), device="cpu") is None
    assert open(_hist_path(cfg["EXP_PATH"])).read() == before
    # a raised epoch target is the explicit train-longer request
    assert F.train_fold(dict(cfg, RESUME=True, EPOCHS=3),
                        device="cpu") is not None
    assert [int(r["epoch"]) for r in _history(
        _hist_path(cfg["EXP_PATH"]))] == [0, 1, 2]


def test_train_fold_resume_without_state_starts_fresh(data, tmp_path):
    cfg = _fold_cfg(data, str(tmp_path / "run"), EPOCHS=1, RESUME=True)
    trainer = F.train_fold(cfg, device="cpu")
    assert trainer.state.step == 9 // CFG["BATCHSIZE"]
    rows = _history(_hist_path(cfg["EXP_PATH"]))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["loss"]))


def test_run_experiment_resume_reenters_prior_run(tmp_path, monkeypatch):
    exp_root = tmp_path / "exp" / "e2e"
    old, new = exp_root / "2026-01-01_00_00", exp_root / "2026-01-02_00_00"
    for d in (old, new):
        d.mkdir(parents=True)
    seen = []
    monkeypatch.setattr(F, "train_fold", lambda cfg, in_memory=True,
                        device="cuda": seen.append(cfg["EXP_PATH"]))
    cfg = dict(CFG, EXPERIMENT="e2e", RESUME=True,
               EXPERIMENTS_ROOT=str(tmp_path / "exp") + "/")
    assert F.run_experiment(cfg) == str(new) and seen == [str(new)]
    seen.clear()
    assert F.run_experiment(dict(cfg, EXP_PATH=str(old))) == str(old)
    assert seen == [str(old)]
    # a config carrying another experiment's run dir falls back to latest
    other = tmp_path / "exp" / "other" / "2026-01-03_00_00"
    other.mkdir(parents=True)
    seen.clear()
    assert F.run_experiment(dict(cfg, EXP_PATH=str(other))) == str(new)
    # no prior run at all: a fresh timestamped dir
    seen.clear()
    fresh = F.run_experiment(dict(cfg, EXPERIMENT="never-ran"))
    assert "never-ran" in fresh and not os.path.isdir(fresh)


def test_resumed_run_experiment_matches_cmrtpu(data, tmp_path, monkeypatch):
    """With EMA 0.9, so the eval columns come from the shadow and the
    restore brings the shadow back. Best-only on val_loc_mm, which a 1e-3
    head prior keeps constant: both packages restore epoch 0's state and
    retrain epochs 1 and 2."""
    cfg = dict(CFG, HEAD_BIAS_PRIOR=0.001, EMA=0.9)
    captured = {}

    def capture(model, config, rng):
        variables = init_variables(model, config, rng)
        captured.setdefault("params", jax.tree_util.tree_map(
            np.array, dict(variables["params"])))
        return variables

    monkeypatch.setattr(jax_trainer, "init_variables", capture)
    jax_exp = str(tmp_path / "jax")
    jax_run_experiment(dict(cfg), data_path=data, exp_path=jax_exp)
    jax_run_experiment(dict(cfg, EPOCHS=3, RESUME=True), data_path=data,
                       exp_path=jax_exp)

    def from_cmrtpu(config, supervision=False):
        model = get_model(config, supervision=supervision)
        model.load_state_dict(flax_to_state_dict(captured["params"]))
        return model

    monkeypatch.setattr(port_trainer, "init_model", from_cmrtpu)
    torch_exp = str(tmp_path / "torch")
    run_experiment = F.run_experiment
    run_experiment(dict(cfg), data_path=data, exp_path=torch_exp,
                   device="cpu")
    first = open(_hist_path(torch_exp)).read().splitlines()
    run_experiment(dict(cfg, EPOCHS=3, RESUME=True), data_path=data,
                   exp_path=torch_exp, device="cpu")
    ref, got = _history(_hist_path(jax_exp)), _history(_hist_path(torch_exp))
    assert [int(r["epoch"]) for r in got] == [0, 1, 2]
    assert len(ref) == 3 and list(got[0]) == list(ref[0])
    for r, g in zip(ref, got):
        for key in r:
            if key != "epoch_time":
                assert float(g[key]) == pytest.approx(
                    float(r[key]), rel=1e-4, abs=1e-6), key
    assert open(_hist_path(torch_exp)).read().splitlines()[:2] == first[:2]
    # model.npz holds the shadow of the state saved beside it
    model_dir = os.path.join(torch_exp, "f0", "model")
    state = restore_train_state(model_dir)
    saved = flax_to_state_dict(*load_weights(model_dir))
    for name, tensor in state["ema"].items():
        assert torch.equal(saved[name], tensor), name
        assert not torch.equal(state["model"][name], tensor), name


def _exact_cfg(**extra):
    return dict(CFG, SHUFFLE=False, AUGMENT=True, RANDOMROTATE=True,
                SHIFTSCALEROTATE=True, GRIDDISTORTION=True, DROPOUT_MIN=0.3,
                DROPOUT_MAX=0.5, SAVE_MODEL_FUNCTION="val_loss",
                SAVE_MODEL_MODE="max", **extra)


def _weights(exp):
    return restore_train_state(os.path.join(exp, "f0", "model"))


def test_resume_equals_uninterrupted_run(data, tmp_path, monkeypatch):
    """Best-only on the HIGHEST val_loss keeps an early epoch, so the resume
    retrains at least one epoch; every value after the restore point and
    the final train state must equal the uninterrupted run's."""
    finals = []
    orig_fit = Trainer.fit_cached

    def keep_final(self, *args, **kwargs):
        out = orig_fit(self, *args, **kwargs)
        finals.append({k: v.clone()
                       for k, v in self.model.state_dict().items()})
        return out

    monkeypatch.setattr(Trainer, "fit_cached", keep_final)
    straight = F.run_experiment(_exact_cfg(EPOCHS=3), data_path=data,
                                exp_path=str(tmp_path / "a"), device="cpu")
    resumed, control = str(tmp_path / "b"), str(tmp_path / "c")
    for exp in (resumed, control):
        F.run_experiment(_exact_cfg(EPOCHS=2), data_path=data, exp_path=exp,
                         device="cpu")
    state = _weights(resumed)
    restore_epoch = state["step"] // (9 // CFG["BATCHSIZE"])
    assert 1 <= restore_epoch < 3
    F.run_experiment(_exact_cfg(EPOCHS=3, RESUME=True), data_path=data,
                     exp_path=resumed, device="cpu")
    orig_restore = Trainer.restore

    def forget_generators(self, ckpt_dir):
        step = orig_restore(self, ckpt_dir)
        seed = int(self.config.get("SEED", 42))
        self.generator.manual_seed(seed)
        self.loop_generator.manual_seed(seed + 1)
        return step

    monkeypatch.setattr(Trainer, "restore", forget_generators)
    F.run_experiment(_exact_cfg(EPOCHS=3, RESUME=True), data_path=data,
                     exp_path=control, device="cpu")

    def values(exp):
        return [{k: v for k, v in r.items() if k != "epoch_time"}
                for r in _history(_hist_path(exp))]

    assert values(resumed) == values(straight)
    assert values(control)[restore_epoch:] != values(straight)[
        restore_epoch:]
    # fits: straight, resumed and control to 2 epochs, the resume, the
    # control's resume; the resumed weights equal the straight run's
    assert len(finals) == 5
    for name, tensor in finals[3].items():
        assert torch.equal(tensor, finals[0][name]), name
    assert any(not torch.equal(t, finals[0][n]) for n, t in
               finals[4].items())


def test_state_roundtrip_bit_for_bit(data, tmp_path):
    cfg = dict(CFG, EMA=0.9, OPTIMIZER="sgd", MOMENTUM=0.9, AGC=0.08)
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 1)).astype(np.float32))
    y = torch.zeros(4, 32, 32, 2)
    y[:, 4:8, 4:8, 1] = 1.0
    for _ in range(3):
        trainer.state.train_step(x, y)
    trainer.set_lr(3e-5)
    torch.rand(5, generator=trainer.loop_generator)
    cb = ModelCheckpoint(str(tmp_path))
    cb.on_epoch_end(trainer, 0, {"loss": 1.0})
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.state.train_step(x, y)  # moves everything after the snapshot
    cb.on_train_end(trainer)  # flush
    fresh = Trainer(dict(cfg, OPTIMIZER="adam"), device="cpu")
    assert fresh.restore(str(tmp_path)) == 3
    assert fresh.optimizer_name == "sgd" and fresh.get_lr() == \
        pytest.approx(3e-5)
    saved = restore_train_state(str(tmp_path))
    for name, tensor in fresh.model.state_dict().items():
        assert torch.equal(tensor, want[name]), name
    for i, p in enumerate(fresh.model.parameters()):
        assert torch.equal(fresh.optimizer.state[p]["trace"],
                           saved["optimizer"]["state"][i]["trace"])
    for name, tensor in fresh.state.ema.items():
        assert torch.equal(tensor, saved["ema"][name]), name
    assert torch.equal(fresh.generator.get_state(),
                       saved["generators"]["dropout"])
    assert torch.equal(fresh.loop_generator.get_state(),
                       saved["generators"]["loop"])
    assert not torch.equal(fresh.loop_generator.get_state(),
                           Trainer(cfg, device="cpu").loop_generator
                           .get_state())


@pytest.mark.parametrize("saved,now", [
    ({"AGC": 0.08}, {}),
    ({}, {"AGC": 0.08, "EPSILON": 1e-5}),
    ({"OPTIMIZER": "sgd", "MOMENTUM": 0.9, "AGC": 0.08},
     {"OPTIMIZER": "sgd"}),
], ids=["agc-dropped", "agc-added", "sgd-momentum-dropped"])
def test_restore_keeps_the_configs_hyperparameters(tmp_path, saved, now):
    """A resumed run takes the saved moments, step count and learning rate,
    and AGC, EPSILON and MOMENTUM from its own config."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 1)).astype(np.float32))
    y = torch.zeros(4, 32, 32, 2)
    y[:, 4:8, 4:8, 1] = 1.0
    trainer = Trainer(dict(CFG, **saved), device="cpu")
    for _ in range(2):
        trainer.state.train_step(x, y)
    trainer.set_lr(3e-5)
    cb = ModelCheckpoint(str(tmp_path))
    cb.on_epoch_end(trainer, 0, {"loss": 1.0})
    cb.on_train_end(trainer)
    cfg = dict(CFG, **now)
    fresh = Trainer(cfg, device="cpu")
    assert fresh.restore(str(tmp_path)) == 2
    group = fresh.optimizer.param_groups[0]
    assert group["count"] == 2 and fresh.get_lr() == pytest.approx(3e-5)
    assert group["agc"] == cfg.get("AGC")
    assert group["eps"] == cfg.get("EPSILON", 1e-8)
    assert group["momentum"] == cfg.get("MOMENTUM")
    logs = fresh.state.train_step(x, y)
    assert np.isfinite(float(logs["loss"]))
    assert group["count"] == 3


def test_cli_resume_of_a_complete_fold_changes_nothing(data, tmp_path):
    cfg = dict(CFG, EPOCHS=1, EXPERIMENTS_ROOT=str(tmp_path / "exp"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    exp = train_main(["-cfg", str(path), "-data", data, "--device", "cpu"])

    def snapshot():
        out = {}
        for d, _, files in os.walk(exp):
            for f in files:
                p = os.path.join(d, f)
                out[p] = (os.path.getmtime(p), open(p, "rb").read())
        return out

    before = snapshot()
    assert train_main(["-cfg", str(path), "-data", data, "-resume", exp,
                       "--device", "cpu"]) == exp
    assert snapshot() == before
