"""cmrtpu_torch's serving export against cmrtpu's
(``cmrtpu/predict/export.py``, ``cmrtpu/cli/export.py``).

``fold_batch_norm`` is the same float64 arithmetic on the same numpy
arrays, so bit-equal; the folded net within 1e-5 of the unfolded one and
the artifact within 1e-5 of the live Predictor (cmrtpu's contract,
tests/test_export.py). The artifact directory keeps cmrtpu's export.json
keys and writes the same weights.npz as cmrtpu's export of the same
fold."""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict import export as JE
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.cli.export import main as export_main
from cmrtpu_torch.cli.serve import main as serve_main
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.predict import export as E
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.predict.serving import ServingEngine
from cmrtpu_torch.train.checkpoint import flax_to_state_dict, load_weights

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
       "MASK_VALUES": [1, 2], "BATCHSIZE": 4, "MIXED_PRECISION": False,
       "GROUP_NORM": 4, "SPACING": [1.0, 1.0], "RESAMPLE": True,
       "SCALER": "MinMax", "SEED": 0}
BN_FIRST = dict(CFG, GROUP_NORM=0, BATCH_NORMALISATION=True, BN_FIRST=True)


def _fold(tmp_path, cfg, seed=0, stats_shift=True):
    """A fold dir written by cmrtpu: config + model.npz of a flax init,
    with BatchNorm statistics moved off their init values."""
    variables = jax.tree_util.tree_map(np.asarray, dict(init_variables(
        jax_build_model(cfg), cfg, jax.random.key(seed,
                                                  impl="threefry2x32"))))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(a.dtype),
        variables.get("batch_stats", {})) if stats_shift else \
        variables.get("batch_stats", {})
    fold = tmp_path / f"f{seed}"
    (fold / "config").mkdir(parents=True)
    (fold / "config" / "config.json").write_text(json.dumps(cfg))
    jax_ckpt.save_weights(str(fold / "model"), variables["params"], stats)
    return str(fold)


def _x(n=4):
    return np.random.default_rng(1).normal(size=(n, 32, 32, 1)).astype(
        np.float32)


def test_fold_batch_norm_is_bit_equal_and_exact(tmp_path):
    fold = _fold(tmp_path, BN_FIRST)
    params, stats = load_weights(os.path.join(fold, "model"))
    jcfg, jparams = JE.fold_batch_norm(BN_FIRST, params, stats)
    pcfg, pparams = E.fold_batch_norm(BN_FIRST, params, stats)
    assert pcfg == jcfg and pcfg["BATCH_NORMALISATION"] is False
    want = jax.tree_util.tree_leaves_with_path(jparams)
    got = dict((jax.tree_util.keystr(p), v) for p, v in
               jax.tree_util.tree_leaves_with_path(pparams))
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, leaf in want:
        g = got[jax.tree_util.keystr(path)]
        assert g.dtype == leaf.dtype and g.tobytes() == \
            np.asarray(leaf).tobytes()
    x = torch.from_numpy(_x())
    live = Predictor(BN_FIRST, os.path.join(fold, "model"), device="cpu")
    folded = build_model(pcfg)
    folded.load_state_dict(flax_to_state_dict(pparams, {}))
    with torch.no_grad():
        np.testing.assert_allclose(folded.eval()(x).numpy(),
                                   live.model(x).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="BN_FIRST"):
        E.fold_batch_norm(dict(BN_FIRST, BN_FIRST=False), params, stats)


@pytest.mark.parametrize("cfg,kwargs", [
    (CFG, {}), (dict(CFG, TTA=True), {}),
    (dict(CFG, TTA=True, TTA_MODE="coords"), {}),
    (dict(CFG, HEADS=[["rvip", 2, "sigmoid"], ["seg", 3, "softmax"]]), {}),
    (BN_FIRST, {"fold_bn": True})],
    ids=["plain", "tta-probs", "tta-coords", "heads", "fold-bn"])
def test_artifact_round_trip_matches_live_predictor(cfg, kwargs, tmp_path):
    fold = _fold(tmp_path, cfg)
    out = str(tmp_path / "art")
    E.export_model(cfg, os.path.join(fold, "model"), out, batch=4,
                   device="cpu", **kwargs)
    fn, meta = E.load_exported(out, device="cpu")
    assert meta["x_shape"] == [4, 32, 32, 1] and meta["device"] == "cpu"
    weights = E.load_exported_weights(out, device="cpu")
    x = _x()
    served = fn(weights, torch.from_numpy(x))
    live = Predictor(cfg, os.path.join(fold, "model"), device="cpu").predict(x)
    if isinstance(live, dict):
        for name in live:
            np.testing.assert_allclose(served[name].numpy(), live[name],
                                       atol=1e-5)
    else:
        np.testing.assert_allclose(served.numpy(), live, atol=1e-5)
    if kwargs.get("fold_bn"):
        assert not any(k.startswith("batch_stats/") for k in
                       np.load(os.path.join(out, E.WEIGHTS)).files)


def test_artifact_layout_matches_cmrtpus_export(tmp_path):
    fold = _fold(tmp_path, BN_FIRST)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    E.export_model(BN_FIRST, os.path.join(fold, "model"), ours, batch=2,
                   device="cpu")
    JE.export_model(BN_FIRST, os.path.join(fold, "model"), theirs, batch=2)
    with open(os.path.join(ours, E.META)) as fh:
        meta = json.load(fh)
    with open(os.path.join(theirs, JE.META)) as fh:
        jmeta = json.load(fh)
    assert set(meta) == set(jmeta) | {"device"}
    for key in ("x_shape", "dim", "mask_classes"):
        assert meta[key] == jmeta[key]
    assert meta["config"] == jmeta["config"]
    # the weights ride in weights.npz only: the program stores no tensor
    with zipfile.ZipFile(os.path.join(ours, E.ARTIFACT)) as z:
        assert sum(i.file_size for i in z.infolist()
                   if "/data/" in i.filename
                   and not i.filename.endswith(".json")) == 0
    with np.load(os.path.join(ours, E.WEIGHTS)) as a, \
            np.load(os.path.join(theirs, JE.WEIGHTS)) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key


def test_swapped_weights_change_what_is_served(tmp_path):
    """weights.npz rides beside the program: another fold's weights
    dropped in serve that fold, without a re-export."""
    a, b = _fold(tmp_path, CFG, seed=0), _fold(tmp_path, CFG, seed=1)
    out = str(tmp_path / "art")
    E.export_model(CFG, os.path.join(a, "model"), out, batch=4, device="cpu")
    fn, _ = E.load_exported(out, device="cpu")
    x = torch.from_numpy(_x())
    before = fn(E.load_exported_weights(out, device="cpu"), x).numpy()
    shutil.copyfile(os.path.join(b, "model", "model.npz"),
                    os.path.join(out, E.WEIGHTS))
    after = fn(E.load_exported_weights(out, device="cpu"), x).numpy()
    live_b = Predictor(CFG, os.path.join(b, "model"), device="cpu")
    np.testing.assert_allclose(after, live_b.predict(_x()), atol=1e-5)
    assert np.abs(after - before).max() > 1e-3


def test_artifact_device_is_recorded_and_held(tmp_path):
    """ROADMAP Queue 3: a program traced on the card names cuda in its
    graph, so export.json records the device type and loading the
    artifact on another one raises; cmrtpu's artifact serves CPU and TPU
    alike. A cmrtpu artifact raises naming the port's export route."""
    fold = _fold(tmp_path, CFG)
    out = str(tmp_path / "art")
    E.export_model(CFG, os.path.join(fold, "model"), out, batch=4,
                   device="cpu")
    with open(os.path.join(out, E.META)) as fh:
        meta = json.load(fh)
    with open(os.path.join(out, E.META), "w") as fh:
        json.dump(dict(meta, device="cuda"), fh)
    with pytest.raises(ValueError, match="traced on 'cuda'"):
        E.load_exported(out, device="cpu")
    theirs = str(tmp_path / "theirs")
    JE.export_model(CFG, os.path.join(fold, "model"), theirs, batch=4)
    with pytest.raises(ValueError, match="cmrtpu_torch.cli.export -exp"):
        ServingEngine(artifact_dir=theirs, device="cpu")


def test_int8_export_serves_the_twin(tmp_path):
    from cmrtpu_torch.predict.quantize import quantize_model

    cfg = dict(CFG, GROUP_NORM=0, BATCH_NORMALISATION=True)
    fold = _fold(tmp_path, cfg)
    out = str(tmp_path / "art")
    x = _x()
    E.export_model(cfg, os.path.join(fold, "model"), out, batch=4,
                   int8_calib=[x], device="cpu")
    fn, meta = E.load_exported(out, device="cpu")
    assert meta["config"]["QUANT_INT8"] is True
    served = fn(E.load_exported_weights(out, device="cpu"),
                torch.from_numpy(x)).numpy()
    params, stats = load_weights(os.path.join(fold, "model"))
    qcfg, qvars = quantize_model(cfg, {"params": params,
                                       "batch_stats": stats}, [x],
                                 device="cpu")
    twin = build_model(qcfg)
    twin.load_state_dict(flax_to_state_dict(qvars["params"],
                                            qvars["batch_stats"]))
    with torch.no_grad():
        np.testing.assert_allclose(served, twin.eval()(
            torch.from_numpy(x)).numpy(), atol=1e-5)
    with np.load(os.path.join(out, E.WEIGHTS)) as blobs:
        assert any(blobs[k].dtype == np.int8 for k in blobs.files)


_SERVE_WITHOUT_MODELS = """
import json, sys
from cmrtpu_torch.cli.serve import main
totals = main(sys.argv[1:])
loaded = sorted(m for m in sys.modules
                if m.startswith("cmrtpu_torch.models") or
                m.split(".")[0] in ("jax", "cmrtpu", "flax"))
print(json.dumps({"studies": totals["studies"], "loaded": loaded}))
"""


def test_cli_export_then_serve_artifact_without_model_code(tmp_path):
    """cli.export writes the artifact, and a fresh interpreter serves it
    through cli.serve -artifact without importing cmrtpu_torch.models;
    the labels equal the live fold's."""
    fold = _fold(tmp_path, dict(CFG, CC_FILTER=True))
    out = str(tmp_path / "art")
    export_main(["-exp", fold, "-out", out, "--batch", "2",
                 "--device", "cpu"])
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    study = str(in_dir / "s.nrrd")
    write_image(MedicalImage(array=np.random.default_rng(2).normal(
        size=(3, 24, 28)).astype(np.float32), spacing=(1.5, 1.5, 8.0)), study)
    os.utime(study, (0, 0))
    env = dict(os.environ, PYTHONPATH=REPO, CMRTPU_PLATFORM="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_WITHOUT_MODELS, "-artifact", out,
         "-in", str(in_dir), "-out", str(tmp_path / "served"),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record == {"studies": 1, "loaded": []}
    serve_main(["-exp", fold, "-in", str(in_dir), "-out",
                str(tmp_path / "live"), "--device", "cpu"])
    a = read_image(str(tmp_path / "served" / "s_msk_pred.nrrd"))
    b = read_image(str(tmp_path / "live" / "s_msk_pred.nrrd"))
    np.testing.assert_array_equal(a.array, b.array)
    assert a.spacing == b.spacing
