"""cmrtpu_torch's A/B tools (``cmrtpu_torch/tools/{predict,tta,int8,
soup}_ab.py``) against cmrtpu's (``tools/*_ab.py``) on the CPU.

One fold is trained by the port (the end-to-end test's tree and config);
each tool then runs through both packages on a fresh copy of that
experiment root at one path, so both read the same model.npz and write
the same twin root. The twins' ``df_eval.csv`` are equal byte for byte,
row by row, except rows of patient-phases where a probability cmrtpu
computes for the twin (or the gt heatmap) lies within 1e-4 (1e-5) of the
0.5 threshold, which the two packages' float orders may round apart
(as ``test_torch_end_to_end._near_threshold`` finds them). The means each port tool
prints (its JSON line) equal pandas' means of the two df_eval.csv files it
names, within 1e-12 relative. The int8 twins' threshold band is 1e-3,
the bound of a twin's probabilities against cmrtpu's
(tests/test_torch_quantize.py)."""

import glob
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from cmrtpu_torch.cli import make_dataset as cli_md
from cmrtpu_torch.data.dataset import fold_patients
from cmrtpu_torch.io import read_image
from cmrtpu_torch.predict.predictor import pred_fold
from cmrtpu_torch.tools import int8_ab, predict_ab, soup_ab, tta_ab
from cmrtpu_torch.tools.columns import COLS
from cmrtpu_torch.train.checkpoint import (_flatten, _unflatten,
                                           flax_to_state_dict, load_weights,
                                           save_weights)
from cmrtpu_torch.train.fold import train_fold
from test_torch_end_to_end import (GT_ATOL, PRED_ATOL, _fold_cfg,
                                   _near_threshold, _write_tree)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_RTOL = 1e-12
# the int8 twins: each package calibrates its own tree (max-abs within
# rtol 1e-5 of each other), and a whole twin's probabilities lie within
# 1e-3 of cmrtpu's on one tree (tests/test_torch_quantize.py)
INT8_ATOL = 1e-3


def _jax_tool(name):
    """cmrtpu's tools/<name>.py as a module (tta_ab imports predict_ab as
    a top-level module from its own directory)."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(data root, experiment root, pristine copy, soup root, its copy):
    fold 0 trained by the port; the soup root adds f1, f0's weights plus
    seeded noise with FOLD 1, predicted by the port."""
    base = tmp_path_factory.mktemp("ab")
    data_root = str(base / "data")
    os.makedirs(os.path.join(data_root, "io"))
    _write_tree(data_root)
    cli_md.cli(["-data_root", data_root, "-acdc_data",
                os.path.join(data_root, "original")])
    exp = str(base / "exp" / "run")
    train_fold(_fold_cfg(data_root, exp), device="cpu")
    pristine = str(base / "pristine")
    shutil.copytree(exp, pristine)

    soup_src = str(base / "soup_pristine")
    shutil.copytree(exp, soup_src)
    f1 = os.path.join(soup_src, "f1")
    params, stats = load_weights(os.path.join(exp, "f0", "model"))
    rng = np.random.default_rng(5)
    noisy = {k: (v + rng.normal(0, 0.05 * float(v.std()) + 1e-6, v.shape)
                 ).astype(v.dtype) for k, v in _flatten(params).items()}
    save_weights(os.path.join(f1, "model"),
                 flax_to_state_dict(_unflatten(noisy), stats))
    with open(os.path.join(exp, "f0", "config", "config.json")) as fh:
        cfg = json.load(fh)
    cfg.update(FOLD=1, EXP_PATH=f1, MODEL_PATH=os.path.join(f1, "model"))
    os.makedirs(os.path.join(f1, "config"))
    with open(os.path.join(f1, "config", "config.json"), "w") as fh:
        json.dump(cfg, fh)
    assert pred_fold(cfg, device="cpu")
    return data_root, exp, pristine, str(base / "soup" / "run"), soup_src


def _fresh(root, pristine):
    """``root`` restored from ``pristine``, its twin roots removed."""
    for d in glob.glob(root + "*"):
        shutil.rmtree(d)
    shutil.copytree(pristine, root)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _json_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"means"')][-1])


def _compare(ref_twin, twin, atol):
    """The twins' df_eval.csv, row by row: the header equal; a row that
    differs must be of a patient-phase whose written label files differ,
    and only at pixels where cmrtpu's twin probability (or gt heatmap)
    lies within ``atol`` (GT_ATOL) of 0.5. Returns the rows equal."""
    ref = _read(os.path.join(ref_twin, "df_eval.csv")).splitlines()
    got = _read(os.path.join(twin, "df_eval.csv")).splitlines()
    assert len(ref) == len(got) > 1 and ref[0] == got[0]
    header = ref[0].decode().split(",")
    i_p, i_ph = header.index("patient"), header.index("phase")
    near, equal = None, 0
    for a, b in zip(ref[1:], got[1:]):
        if a == b:
            equal += 1
            continue
        p, phase = (a.decode().split(",")[i] for i in (i_p, i_ph))
        if near is None:  # cmrtpu's twin probabilities, from its own tree
            with open(os.path.join(ref_twin, "f0", "config",
                                   "config.json")) as fh:
                cfg = json.load(fh)
            cfg["MODEL_PATH"] = os.path.join(ref_twin, "f0", "model")
            near = _near_threshold(cfg, fold_patients(cfg["DF_FOLDS"], 0),
                                   atol, GT_ATOL)
        changed = False
        for sub, kind in (("pred", "pred"), ("gt", "gt")):
            name = os.path.join("f0", sub, f"{p}_{phase}_msk.nrrd")
            differ = read_image(os.path.join(ref_twin, name)).array != \
                read_image(os.path.join(twin, name)).array
            assert not (differ & ~near[kind, p, phase]).any(), name
            changed |= bool(differ.any())
        assert changed, f"{p} {phase}: equal label files, unequal rows"
    return equal


def _check_means(result):
    """The port's printed means equal pandas' means of the two files."""
    for name, path in result["df_eval"].items():
        df = pd.read_csv(path)
        for col, got in result["means"][name].items():
            want = float(df[col].mean())
            assert got == pytest.approx(want, rel=MEAN_RTOL, nan_ok=True), \
                (name, col)


def _run_both(jax_main, port_main, argv, root, pristine, twin_suffix,
              ref_dir, capsys, atol=PRED_ATOL):
    """cmrtpu's tool, then the port's on the CPU, each on a fresh copy of
    the root at the same path; cmrtpu's twin is kept under ``ref_dir``.
    Returns the port's result and the twin rows that were byte-equal."""
    _fresh(root, pristine)
    jax_main(argv)
    twin = root + twin_suffix
    ref_twin = os.path.join(ref_dir, "twin")
    shutil.copytree(twin, ref_twin)
    ref_plain = _read(os.path.join(root, "df_eval.csv"))
    _fresh(root, pristine)
    capsys.readouterr()
    result = port_main(argv + ["--device", "cpu"])
    printed = _json_line(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(result))
    assert _read(os.path.join(root, "df_eval.csv")) == ref_plain
    rows = _compare(ref_twin, twin, atol)
    _check_means(result)
    return result, rows


def test_predict_ab_cc3d_matches_cmrtpu(trained, capsys, tmp_path):
    data_root, exp, pristine, _, _ = trained
    argv = ["-exp", exp, "-data", data_root, "--set", "CC_FILTER=3d",
            "--suffix", "cc3d"]
    result, rows = _run_both(_jax_tool("predict_ab").main, predict_ab.main,
                             argv, exp, pristine, "_cc3d", tmp_path, capsys)
    assert set(result["means"]) == {"plain", "twin"}
    assert set(result["means"]["twin"]) == set(COLS)


@pytest.mark.parametrize("mode", ["coords", "probs"])
def test_tta_ab_matches_cmrtpu(trained, capsys, monkeypatch, mode, tmp_path):
    data_root, exp, pristine, _, _ = trained
    jax_tta = _jax_tool("tta_ab")

    def jax_main(argv):
        monkeypatch.setattr(sys, "argv", ["tta_ab.py"] + argv)
        jax_tta.main()

    argv = ["-exp", exp, "-data", data_root, "--mode", mode]
    result, _ = _run_both(jax_main, tta_ab.main, argv, exp, pristine,
                          f"_tta_{mode}", tmp_path, capsys)
    with open(os.path.join(exp + f"_tta_{mode}", "f0", "config",
                           "config.json")) as fh:
        cfg = json.load(fh)
    assert cfg["TTA"] is True and cfg["TTA_MODE"] == mode


def test_int8_ab_matches_cmrtpu(trained, capsys, tmp_path, monkeypatch):
    """Both tools quantize the same fold on the same calibration studies.
    The GroupNorm refit reads int8 activations, so one flipped int8 step
    moves the refit's moments: the two packages' GroupNorm affines differ
    by ~5e-5 relative on this fold and their twins' probabilities by up
    to 0.14. So the port's own tree is held leaf by leaf (int8 kernels
    equal, the float leaves but the GroupNorm affines within rtol 1e-5,
    the calibration's bound in tests/test_torch_quantize.py) and the
    port's tool then
    predicts from cmrtpu's tree, so the flow after it (pred_fold, the
    evaluation, the means) is held against cmrtpu's on one tree."""
    import cmrtpu.predict.quantize as JQ
    import cmrtpu_torch.predict.quantize as Q

    data_root, exp, pristine, _, _ = trained
    calls = {"jax": [], "port": []}
    ref_npz = os.path.join(tmp_path, "twin", "f0", "model", "model.npz")
    own = {}

    def recording(kind, real):
        def quantize(fold_dir, calib, *args, **kwargs):
            calls[kind].append((fold_dir, list(calib)))
            out = real(fold_dir, calib, *args, **kwargs)
            if kind == "port":
                npz = os.path.join(out, "model", "model.npz")
                own.update(np.load(npz))
                shutil.copy(ref_npz, npz)
            return out
        return quantize

    monkeypatch.setattr(JQ, "quantize_fold",
                        recording("jax", JQ.quantize_fold))
    monkeypatch.setattr(Q, "quantize_fold", recording("port", Q.quantize_fold))
    argv = ["-exp", exp, "-data", data_root, "--calib-studies", "4"]
    result, _ = _run_both(_jax_tool("int8_ab").main, int8_ab.main, argv,
                          exp, pristine, "_int8", tmp_path, capsys,
                          atol=INT8_ATOL)
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1
    assert len(calls["jax"][0][1]) == 4
    ref = np.load(ref_npz)
    assert set(own) == set(ref.files)
    for key in ref.files:
        if "GroupNorm" in key:
            continue
        if ref[key].dtype == np.int8:
            np.testing.assert_array_equal(own[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(own[key], ref[key], rtol=1e-5,
                                       err_msg=key)
    assert set(result["means"]) == {"float", "int8"}
    with open(os.path.join(exp + "_int8", "f0", "config",
                           "config.json")) as fh:
        assert json.load(fh)["QUANT_INT8"] is True


def test_soup_ab_matches_cmrtpu(trained, capsys, tmp_path):
    data_root, _, _, root, pristine = trained
    argv = ["-exp", root, "-data", data_root]
    result, _ = _run_both(_jax_tool("soup_ab").main, soup_ab.main, argv,
                          root, pristine, "_soup", tmp_path, capsys)
    assert set(result["means"]) == {"cv", "soup"}
    # two folds of 2 and 2 test patients x ED/ES
    assert len(pd.read_csv(result["df_eval"]["soup"])) == 8


def test_soup_ab_of_an_int8_root_raises(trained, tmp_path):
    data_root, exp, pristine, _, _ = trained
    _fresh(exp, pristine)
    int8_ab.main(["-exp", exp, "-data", data_root, "--calib-studies", "2",
                  "--device", "cpu"])
    with pytest.raises(ValueError, match="soup the float root"):
        soup_ab.main(["-exp", exp + "_int8", "-data", data_root,
                      "--device", "cpu"])
