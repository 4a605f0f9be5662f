"""cmrtpu_torch's serving engine, directory loop and CLI against cmrtpu's.

The same tiny fold (one model.npz written by cmrtpu) and the same synthetic
studies go through cmrtpu's ServingEngine + serve_directory and through the
port's with device='cpu' and CC_FILTER on. The written predictions, their
headers, the marker names and the latency-record keys must be equal. The
head kernel is scaled so the logits are large, and the fixture asserts that
no probability lies within 1e-4 of the 0.5 threshold on either side, which
makes the thresholded labels — and so the comparison — exact."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cmrtpu.io import MedicalImage, read_image, write_image
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict.serving import ServingEngine as JaxEngine
from cmrtpu.predict.serving import serve_directory as jax_serve_directory
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.cli.serve import main as serve_main
from cmrtpu_torch.ops.connected_components import clean_prediction_2d_cc
from cmrtpu_torch.predict.predictor import (preprocess_model_input,
                                            threshold_and_flatten)
from cmrtpu_torch.predict.serving import ServingEngine, serve_directory

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
       "MASK_VALUES": [1, 2], "BATCHSIZE": 4, "MIXED_PRECISION": False,
       "SPACING": [1.0, 1.0], "RESAMPLE": True, "SCALER": "MinMax",
       "GROUP_NORM": 4, "CC_FILTER": True, "SEED": 11}
# z=5 runs through two chunks of BATCHSIZE 4; .nii.gz and .nrrd both served
STUDIES = (("s0.nrrd", 2, 0), ("s1.nii.gz", 3, 1), ("s2.nrrd", 5, 2))
MARGIN = 1e-4


def _study(path: str, z: int, seed: int) -> MedicalImage:
    rng = np.random.default_rng(seed)
    img = MedicalImage(array=rng.normal(size=(z, 24, 28)).astype(np.float32),
                       spacing=(1.5, 1.5, 8.0), origin=(3.0, -2.0, 10.0))
    write_image(img, path)
    os.utime(path, (0, 0))  # settled (serve defers files younger than settle_s)
    return img


@pytest.fixture(scope="module")
def fold_dir(tmp_path_factory):
    """A 'trained' fold: config + model.npz written by cmrtpu, head kernel
    scaled x50 so thresholded labels have a wide margin at 0.5."""
    d = tmp_path_factory.mktemp("fold")
    variables = dict(init_variables(jax_build_model(CFG), CFG,
                                    jax.random.key(11, impl="threefry2x32")))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    params["head"] = {"kernel": params["head"]["kernel"] * 50.0,
                      "bias": params["head"]["bias"]}
    jax_ckpt.save_weights(str(d / "model"), params)
    (d / "config").mkdir()
    (d / "config" / "config.json").write_text(json.dumps(CFG))
    return str(d)


@pytest.fixture(scope="module")
def in_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    for name, z, seed in STUDIES:
        _study(str(d / name), z, seed)
    return str(d)


def _engines(fold_dir):
    model = os.path.join(fold_dir, "model")
    return (JaxEngine(config=CFG, model_path=model),
            ServingEngine(config=CFG, model_path=model, device="cpu"))


def test_served_outputs_match_cmrtpu(fold_dir, in_dir, tmp_path):
    jax_engine, engine = _engines(fold_dir)
    changed = False
    for name, _, _ in STUDIES:
        img = read_image(os.path.join(in_dir, name))
        x = preprocess_model_input(img.array, img.spacing[:2], CFG)
        probs = engine.predict_slices(x)
        ref = np.asarray(jax_engine.predict_slices(x.numpy()))
        assert np.abs(probs - 0.5).min() > MARGIN
        assert np.abs(ref - 0.5).min() > MARGIN
        flat = threshold_and_flatten(probs)
        changed |= bool((clean_prediction_2d_cc(flat).numpy() != flat).any())
    assert changed  # the CC filter removed components in some study

    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    totals_j = jax_serve_directory(jax_engine, in_dir, str(out_j))
    totals_t = serve_directory(engine, in_dir, str(out_t))
    assert totals_t["studies"] == totals_j["studies"] == len(STUDIES)
    assert totals_t["slices"] == totals_j["slices"]
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name, z, _ in STUDIES:
        stem = name.split(".")[0]
        a = read_image(str(out_j / f"{stem}_msk_pred.nrrd"))
        b = read_image(str(out_t / f"{stem}_msk_pred.nrrd"))
        assert b.array.shape == (z, 24, 28)
        np.testing.assert_array_equal(b.array, a.array)
        assert b.spacing == a.spacing
        assert b.origin == a.origin
        assert b.direction == a.direction
        mj = json.loads((out_j / f"{stem}.done.json").read_text())
        mt = json.loads((out_t / f"{stem}.done.json").read_text())
        assert sorted(mt) == sorted(mj)
        assert (mt["outputs"], mt["slices"]) == (mj["outputs"], mj["slices"])


def test_process_study_preprocesses_on_the_engines_device(fold_dir, in_dir,
                                                         tmp_path):
    """One study through ``process_study`` on the CPU: the nrrd it writes
    equals the one cmrtpu's engine writes from its host preprocessing;
    the batch the forward gets is a tensor on the engine's device, and
    ``serve.rows_preprocessed_device`` counts no row, since no CUDA
    device made them."""
    from cmrtpu_torch.utils.profiling import GLOBAL_TIMER

    jax_engine, engine = _engines(fold_dir)
    inputs = []
    forward = engine._forward

    def recording(x):
        inputs.append(x)
        return forward(x)

    engine._forward = recording
    GLOBAL_TIMER.reset()
    name, z, _ = STUDIES[2]
    path = os.path.join(in_dir, name)
    rec = engine.process_study(path, str(tmp_path / "torch"))
    jax_engine.process_study(path, str(tmp_path / "jax"))
    stem = name.split(".")[0]
    got = read_image(str(tmp_path / "torch" / f"{stem}_msk_pred.nrrd"))
    want = read_image(str(tmp_path / "jax" / f"{stem}_msk_pred.nrrd"))
    assert got.array.shape == (z, 24, 28)
    np.testing.assert_array_equal(got.array, want.array)
    assert (got.spacing, got.origin, got.direction) \
        == (want.spacing, want.origin, want.direction)
    assert rec["slices"] == z
    assert len(inputs) == 2  # z 5 in chunks of BATCHSIZE 4
    assert all(isinstance(x, torch.Tensor) and x.device == engine.device
               for x in inputs)
    counts = GLOBAL_TIMER.counts()
    assert counts["serve.rows_preprocessed_device"] == 0
    assert counts["serve.rows_real"] == z


def test_served_outputs_with_3d_cc_match_cmrtpu(fold_dir, in_dir, tmp_path):
    """CC_FILTER '3d': both engines keep the biggest 26-connected component
    per label in each study's volume; the written labels are equal, and
    differ from the per-slice filter's in some study."""
    cfg = dict(CFG, CC_FILTER="3d")
    model = os.path.join(fold_dir, "model")
    out_j, out_t, out_2d = (tmp_path / "jax", tmp_path / "torch",
                            tmp_path / "per_slice")
    jax_serve_directory(JaxEngine(config=cfg, model_path=model), in_dir,
                        str(out_j))
    serve_directory(ServingEngine(config=cfg, model_path=model, device="cpu"),
                    in_dir, str(out_t))
    serve_directory(ServingEngine(config=CFG, model_path=model, device="cpu"),
                    in_dir, str(out_2d))
    differs = False
    for name, z, _ in STUDIES:
        stem = f"{name.split('.')[0]}_msk_pred.nrrd"
        got = read_image(str(out_t / stem)).array
        assert got.shape == (z, 24, 28)
        np.testing.assert_array_equal(got, read_image(str(out_j / stem)).array)
        differs |= bool((got != read_image(str(out_2d / stem)).array).any())
    assert differs


def test_predictor_pads_to_bucket_and_matches_cmrtpu(tmp_path):
    from cmrtpu.predict.predictor import Predictor as JaxPredictor
    from cmrtpu_torch.predict.predictor import Predictor

    # unscaled init weights: the x50 head of ``fold_dir`` scales f32
    # rounding differences by 50 as well
    variables = init_variables(jax_build_model(CFG), CFG,
                               jax.random.key(12, impl="threefry2x32"))
    model = str(tmp_path / "model")
    jax_ckpt.save_weights(model, variables["params"])
    x = np.random.default_rng(9).random((3, 32, 32, 1)).astype(np.float32)
    got = Predictor(CFG, model, device="cpu").predict(x)  # padded 3 -> 8
    want = JaxPredictor(CFG, model).predict(x)
    assert got.shape == want.shape == (3, 32, 32, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_flattening_matches_cmrtpu():
    from cmrtpu.predict import predictor as ref
    from cmrtpu_torch.predict import predictor as port

    probs = np.random.default_rng(8).random((2, 8, 8, 3))
    np.testing.assert_array_equal(port.threshold_and_flatten(probs),
                                  ref.threshold_and_flatten(probs))
    # rounded to tenths: ties, where the first maximum must win
    for p in (probs, np.round(probs, 1)):
        for act in ("sigmoid", "softmax"):
            np.testing.assert_array_equal(port.flatten_head(p, act),
                                          ref.flatten_head(p, act))
    (suffix, flat, gt, values), = port._head_outputs(CFG, probs, None)
    (r_suffix, r_flat, r_gt, r_values), = ref._head_outputs(CFG, probs, None)
    assert (suffix, gt, values) == (r_suffix, r_gt, r_values)
    np.testing.assert_array_equal(flat, r_flat)


@pytest.mark.parametrize("mode,cleans", [
    (True, True), ("2d", True), (" True ", True), ("1", True),
    (False, False), ("false", False), ("", False), (None, False)])
def test_cc_clean_fn_modes(mode, cleans):
    from cmrtpu_torch.predict.predictor import cc_clean_fn

    assert (cc_clean_fn({"CC_FILTER": mode}) is clean_prediction_2d_cc) \
        == cleans
    if not cleans:
        assert cc_clean_fn({"CC_FILTER": mode}) is None


def test_cc_clean_fn_rejects_3d_and_typos():
    """'3d' selects the volume cleaner (26-connected, per label); a typo
    raises."""
    from cmrtpu_torch.ops.connected_components import clean_prediction_3d_cc
    from cmrtpu_torch.predict.predictor import cc_clean_fn

    for mode in ("3d", " 3D "):
        assert cc_clean_fn({"CC_FILTER": mode}) is clean_prediction_3d_cc
    with pytest.raises(ValueError, match="expected a boolean"):
        cc_clean_fn({"CC_FILTER": "2D-ish"})


def test_cuda_without_cuda_raises(fold_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(config=CFG, model_path=os.path.join(fold_dir, "model"),
                      device="cuda")


def test_unported_sources_raise(fold_dir, in_dir, tmp_path):
    """The artifact, ensemble and TTA sources are ported now
    (tests/test_torch_export.py, test_torch_ensemble.py, test_torch_tta.py);
    what cannot be served raises: a directory with no artifact, a cmrtpu
    (StableHLO) artifact, a root with no fold, both sources at once."""
    with pytest.raises(FileNotFoundError):
        ServingEngine(artifact_dir=str(tmp_path), device="cpu")
    (tmp_path / "forward.stablehlo").write_bytes(b"")
    with pytest.raises(ValueError, match="cmrtpu_torch.cli.export"):
        ServingEngine(artifact_dir=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no fold configs"):
        ServingEngine(ensemble_root=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="OR an ensemble_root"):
        ServingEngine(artifact_dir=str(tmp_path),
                      ensemble_root=str(tmp_path), device="cpu")
    engine = ServingEngine(config={**CFG, "TTA": True},
                           model_path=os.path.join(fold_dir, "model"),
                           device="cpu")
    assert engine.predict_slices(np.zeros((2, 32, 32, 1), np.float32)
                                 ).shape == (2, 32, 32, 2)
    with pytest.raises(ValueError, match="cmrtpu_torch.cli.export"):
        serve_main(["-artifact", str(tmp_path), "-in", in_dir,
                    "-out", str(tmp_path / "o"), "--device", "cpu"])


def test_cli_serves_a_directory(fold_dir, in_dir, tmp_path, capsys):
    out = tmp_path / "out"
    totals = serve_main(["-exp", fold_dir, "-in", in_dir, "-out", str(out),
                         "--device", "cpu", "--max-studies", "2"])
    assert totals["studies"] == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == totals
    done = sorted(p for p in os.listdir(out) if p.endswith(".done.json"))
    assert done == ["s0.done.json", "s1.done.json"]
    for marker in done:
        record = json.loads((out / marker).read_text())
        assert "error" not in record
        stem = marker[:-len(".done.json")]
        assert record["outputs"] == [f"{stem}_msk_pred.nrrd"]
        assert (out / f"{stem}_msk_pred.nrrd").exists()
