"""Training the hybrids, the (2+1)D U-Net and deep supervision through
cmrtpu_torch's device-resident loop, against cmrtpu on the CPU, at
[4, 4, 16, 16] to [8, 4, 32, 32], depth <= 2, 4 filters.

* One cached train step of ``wrapper``, ``avg``, ``concat``,
  ``unet_2p1d`` and deep supervision (3D and 2D) from cmrtpu's weights
  (f32, ELU, dropout 0, AUGMENT off) against ``make_cached_train_step``
  with an identity optimizer: loss and metrics within rel 1e-5, each
  gradient within 1e-3 x its max |value|, the running averages within
  1e-5 (``tests/test_torch_cine.py``'s bounds).
* ``fit_cached`` on written cine files: finite losses that decrease, and
  ``Trainer.predict`` equal to the restored ``Predictor``; the EMA shadow
  and the full-state snapshot cover every hybrid parameter.
* ``Trainer(supervision=True)`` and ``init_model`` build the branch.
* The cine demo's ``--variant wrapper`` at a toy size.
"""

import numpy as np
import pytest
import torch

from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.pipeline.generator import DataGenerator
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train import checkpoint as ckpt
from cmrtpu_torch.train.trainer import Trainer, init_model
from test_torch_cine import BN, FIT, GN, T_FRAMES, _write_cine, \
    cached_step_both

torch.set_num_threads(1)

STEP_BN = dict(BN, ACTIVATION="elu")


@pytest.mark.parametrize("cfg,supervision", [
    (dict(STEP_BN, MODEL_VARIANT="wrapper"), False),
    (dict(STEP_BN, MODEL_VARIANT="avg"), False),
    (dict(GN, ACTIVATION="elu", MODEL_VARIANT="concat"), False),
    (dict(STEP_BN, MODEL_VARIANT="unet_2p1d"), False),
    (dict(GN, ACTIVATION="elu", MODEL_VARIANT="unet_2p1d"), False),
    (STEP_BN, True),
    (dict(STEP_BN, DIM=[16, 16], F_SIZE=[3, 3], M_POOL=[2, 2]), True),
], ids=["wrapper-bn", "avg-bn", "concat-gn", "2p1d-bn", "2p1d-gn",
        "supervision-3d", "supervision-2d"])
def test_cached_train_step_matches_cmrtpu(cfg, supervision):
    cached_step_both(cfg, supervision)


@pytest.mark.parametrize("variant", ["wrapper", "avg", "unet_2p1d"])
def test_fit_cached_trains_and_predictor_restores(variant, tmp_path):
    cfg = dict(FIT, MODEL_VARIANT=variant, EMA=True)
    xs, ys = _write_cine(str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert set(trainer.state.ema) == {
        n for n, _ in trainer.model.named_parameters()}
    hist = trainer.fit_cached(DataGenerator(xs, ys, config=cfg),
                              DataGenerator(xs[:2], ys[:2], config=cfg),
                              epochs=6)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"])
               for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    snapshot = ckpt.device_snapshot(trainer.train_state())
    assert snapshot["model"].keys() == trainer.model.state_dict().keys()

    # a full bucket of the Predictor's (8), so both run one batch alike
    x = np.random.default_rng(1).standard_normal(
        (8, T_FRAMES, 32, 32, 1)).astype(np.float32)
    probs = trainer.predict(x)
    assert probs.shape == (8, T_FRAMES, 32, 32, 2)
    model_dir = str(tmp_path / "model")
    ckpt.save_weights(model_dir, trainer.serving_params)
    served = Predictor(cfg, model_dir, device="cpu").predict(x)
    np.testing.assert_array_equal(served, probs)


def test_supervision_through_the_trainer(tmp_path):
    cfg = dict(FIT, AUGMENT=False)
    model = init_model(cfg, supervision=True)
    assert model.supervision and model.Conv_0.weight.shape == (4, 8, 1, 1, 1)
    trainer = Trainer(cfg, device="cpu", supervision=True)
    for a, b in zip(trainer.model.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)  # the same seeded init
    xs, ys = _write_cine(str(tmp_path), n=4)
    hist = trainer.fit_cached(DataGenerator(xs, ys, config=cfg), epochs=2)
    assert np.isfinite(hist[-1]["loss"])
    assert trainer.model.Conv_0.weight.grad is not None
    ckpt.save_weights(str(tmp_path / "m"), trainer.serving_params)
    served = Predictor(cfg, str(tmp_path / "m"), device="cpu")
    assert served.model.supervision
    x = np.zeros((8, T_FRAMES, 32, 32, 1), np.float32)
    np.testing.assert_array_equal(served.predict(x), trainer.predict(x))
    assert not Trainer(cfg, device="cpu").model.supervision


def test_cine_demo_runs_a_hybrid(tmp_path):
    from cmrtpu_torch.tools.cine_quality_demo import main

    summary = main(["--root", str(tmp_path), "--patients", "4", "--epochs",
                    "1", "--dim", "16", "--t-frames", "4", "--depth", "2",
                    "--filters", "4", "--variant", "wrapper", "--device",
                    "cpu"])
    assert summary["variant"] == "wrapper" and summary["landmarks"] == 16
    assert np.isfinite(summary["loss_last"])


def test_get_model_is_what_the_trainer_builds():
    cfg = dict(GN, MODEL_VARIANT="followed")
    trainer = Trainer(cfg, device="cpu")
    assert type(trainer.model) is type(get_model(cfg))
    assert {n.split(".")[0] for n, _ in trainer.model.named_parameters()} \
        == {"unet_2d", "unet_3d", "head_3d"}
