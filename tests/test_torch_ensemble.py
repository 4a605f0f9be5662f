"""cmrtpu_torch's fold ensemble and model soup against cmrtpu's
(``cmrtpu/predict/ensemble.py``).

Three members written by cmrtpu (flax inits of different seeds) go through
both packages' EnsemblePredictor on the CPU: the vmapped member mean within
1e-4 (the U-Net's f32 tolerance), equal to the mean of the port's
per-member Predictor forwards, head by head for HEADS and under TTA; the
soup bit-equal (the same float64 mean of the same numbers)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict.ensemble import EnsemblePredictor as JaxEnsemble
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.cli.serve import main as serve_main
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.predict.ensemble import EnsemblePredictor, soup_experiment
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.predict.serving import ServingEngine
from cmrtpu_torch.train.checkpoint import state_dict_to_flax

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
       "MASK_VALUES": [1, 2], "BATCHSIZE": 4, "MIXED_PRECISION": False,
       "GROUP_NORM": 4, "SPACING": [1.0, 1.0], "RESAMPLE": True,
       "SCALER": "MinMax", "SEED": 0}
HEADS = [["rvip", 2, "sigmoid"], ["seg", 3, "softmax"]]


def _root(tmp_path, cfg, n=3):
    """An experiment root of n folds, each with cmrtpu-written weights of
    its own seed and the config; the head scaled for label margins."""
    root = tmp_path / "exp" / "ts"
    for k in range(n):
        v = jax.tree_util.tree_map(np.asarray, dict(init_variables(
            jax_build_model(cfg), cfg, jax.random.key(k, impl="threefry2x32"))))
        fold = root / f"f{k}"
        (fold / "config").mkdir(parents=True)
        (fold / "config" / "config.json").write_text(json.dumps(
            dict(cfg, FOLD=k)))
        jax_ckpt.save_weights(str(fold / "model"), v["params"],
                              v.get("batch_stats"))
    return str(root)


def _x():
    return np.random.default_rng(1).normal(size=(3, 32, 32, 1)).astype(
        np.float32)


@pytest.mark.parametrize("extra", [
    {}, {"HEADS": HEADS}, {"TTA": True}, {"TTA": True, "TTA_MODE": "coords"},
    {"GROUP_NORM": 0, "BATCH_NORMALISATION": True}],
    ids=["gn", "heads", "tta-probs", "tta-coords", "bn"])
def test_ensemble_mean_matches_cmrtpu(extra, tmp_path):
    cfg = dict(CFG, **extra)
    root = _root(tmp_path, cfg)
    x = _x()
    ens = EnsemblePredictor.from_exp_root(root, device="cpu")
    assert ens.n_members == 3
    got = ens.predict(x)
    want = JaxEnsemble.from_exp_root(root).predict(x)
    singles = [Predictor(cfg, os.path.join(root, f"f{k}", "model"),
                         device="cpu") for k in range(3)]
    if "HEADS" in extra:
        assert set(got) == set(want) == {"rvip", "seg"}
        for name in got:
            np.testing.assert_allclose(got[name], want[name], atol=1e-4)
        return
    if extra.get("TTA_MODE") == "coords":
        # coords: the members are averaged in probability space first, so
        # the mean of per-member coords forwards is another function
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    np.testing.assert_allclose(got, want, atol=1e-4)
    mean = np.mean([p.predict(x) for p in singles], axis=0)
    np.testing.assert_allclose(got, mean, atol=1e-5)
    members = ens.predict_members(x)
    assert members.shape == (3, 3, 32, 32, 2)
    if not extra:
        np.testing.assert_allclose(members[1], singles[1].predict(x),
                                   atol=1e-5)


def test_dropping_a_member_changes_the_mean(tmp_path):
    root = _root(tmp_path, CFG)
    x = _x()
    full = EnsemblePredictor.from_exp_root(root, device="cpu").predict(x)
    dirs = [os.path.join(root, f"f{k}", "model") for k in range(2)]
    two = EnsemblePredictor(CFG, dirs, device="cpu").predict(x)
    assert np.abs(full - two).max() > 1e-3


def test_soup_is_bit_equal_to_cmrtpus(tmp_path):
    root = _root(tmp_path, dict(CFG, GROUP_NORM=0, BATCH_NORMALISATION=True))
    params, stats = JaxEnsemble.from_exp_root(root).soup()
    got_p, got_s = state_dict_to_flax(
        EnsemblePredictor.from_exp_root(root, device="cpu").soup())
    for want, got in ((params, got_p), (stats, got_s)):
        want = jax.tree_util.tree_leaves_with_path(jax.device_get(want))
        flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in want}
        got = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_leaves_with_path(got)}
        assert sorted(flat) == sorted(got)
        for key in flat:
            assert flat[key].dtype == got[key].dtype, key
            assert flat[key].tobytes() == got[key].tobytes(), key


def test_soup_of_int8_members_raises(tmp_path):
    """ROADMAP Queue 3: cmrtpu's soup() averages int8 trees
    (ensemble.py:92); the port's EnsemblePredictor.soup raises for
    QUANT_INT8 members, not only soup_experiment."""
    from cmrtpu_torch.train.checkpoint import save_weights
    from cmrtpu_torch.models.unet import build_model

    qcfg = dict(CFG, QUANT_INT8=True)
    root = tmp_path / "q"
    dirs = []
    for k in range(2):
        d = root / f"f{k}" / "model"
        save_weights(str(d), build_model(qcfg))
        dirs.append(str(d))
        (root / f"f{k}" / "config").mkdir(parents=True)
        (root / f"f{k}" / "config" / "config.json").write_text(
            json.dumps(qcfg))
    ens = EnsemblePredictor(qcfg, dirs, device="cpu")
    with pytest.raises(ValueError, match="soup the float root"):
        ens.soup()
    with pytest.raises(ValueError, match="soup the float root"):
        soup_experiment(str(root), device="cpu")


def test_ensemble_on_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    root = _root(tmp_path, CFG, n=2)
    with pytest.raises(RuntimeError, match="cuda"):
        EnsemblePredictor.from_exp_root(root)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(ensemble_root=root)


def test_serve_cli_ensemble(tmp_path):
    """cli.serve -ensemble serves a study with the engine batch at
    BATCHSIZE; the written labels are the thresholded member mean."""
    root = _root(tmp_path, dict(CFG, CC_FILTER=True))
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    study = str(in_dir / "s.nrrd")
    write_image(MedicalImage(array=np.random.default_rng(2).normal(
        size=(5, 24, 28)).astype(np.float32), spacing=(1.5, 1.5, 8.0),
        origin=(3.0, -2.0, 10.0)), study)
    os.utime(study, (0, 0))
    totals = serve_main(["-ensemble", root, "-in", str(in_dir), "-out",
                         str(out_dir), "--device", "cpu"])
    assert totals["studies"] == 1
    out = read_image(str(out_dir / "s_msk_pred.nrrd"))
    assert out.array.shape == (5, 24, 28)
    assert out.spacing == pytest.approx((1.5, 1.5, 8.0))
    engine = ServingEngine(ensemble_root=root, device="cpu", warmup=False)
    assert engine.batch == 4 and engine.n_members == 3
