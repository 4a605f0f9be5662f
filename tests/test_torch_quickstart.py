"""cmrtpu_torch's quickstart and results analysis
(``cmrtpu_torch/tools/{synthetic_quickstart,analyze_results}.py``) against
cmrtpu's ``examples/`` scripts on the CPU.

* ``generate_dataset`` writes the same files byte for byte from the same
  seed (slices and ``df_kfold.csv``), and the experiment config equals the
  one cmrtpu's ``main`` hands to its ``run_experiment``, with and without
  ``--ws``.
* A 2-epoch, 4-patient, 32² run with ``--tta --int8`` finishes on the CPU,
  and so does one with ``--ws`` (weight-standardised blocks, no norm).
* ``analyze_results`` on one df_eval.csv (pathologies, empty and text
  cells): ``summary.csv`` equal to cmrtpu's, its text byte for byte and
  its numbers within 1e-12 relative (pandas' ``read_csv`` parses a decimal
  to within an ulp, Python's ``float`` rounds it correctly: the sd of a
  column can differ in its last digit), the per-pathology mean, std and
  count within 1e-12 relative of pandas' groupby; without
  matplotlib the tables are written and the figures skipped with a
  warning.
"""

import builtins
import csv
import glob
import importlib.util
import json
import logging
import math
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from cmrtpu_torch.tools import analyze_results, synthetic_quickstart as QS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-12


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"),
                                 recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_generate_dataset_matches_cmrtpu(tmp_path, capsys):
    import shutil
    root = str(tmp_path / "qs")
    _example("synthetic_quickstart").generate_dataset(
        root, n_patients=4, hw=32, n_slices=2, seed=3)
    ref, ref_out = _tree(root), capsys.readouterr().out
    shutil.rmtree(root)
    QS.generate_dataset(root, n_patients=4, hw=32, n_slices=2, seed=3)
    got = _tree(root)
    assert "df_kfold.csv" in got and len(got) == 1 + 4 * 2 * 2 * 2
    assert got == ref
    assert capsys.readouterr().out == ref_out


class _Stop(Exception):
    pass


def test_config_matches_cmrtpu(tmp_path, monkeypatch):
    import cmrtpu.train.fold as jax_fold

    seen = {}

    def capture(config, data_path=None, **kwargs):
        seen.update(config=config, data_path=data_path)
        raise _Stop

    monkeypatch.setattr(jax_fold, "run_experiment", capture)
    root = str(tmp_path / "qs")
    for flags in ((), ("--ema", "--cache-dtype", "bfloat16"), ("--ws",)):
        monkeypatch.setattr(sys, "argv", [
            "synthetic_quickstart.py", "--root", root, "--epochs", "7",
            "--patients", "4", "--dim", "32", *flags])
        with pytest.raises(_Stop):
            _example("synthetic_quickstart").main()
        assert seen["data_path"] == root
        assert QS.quickstart_config(
            root, 7, 32,
            cache_dtype="bfloat16" if "--ema" in flags else "float32",
            ema="--ema" in flags, ws="--ws" in flags) == seen["config"]


def test_ws_raises_naming_the_skip_list(tmp_path):
    """``--ws`` runs (it raised while WEIGHT_STANDARDISATION was on the
    port's skip list): 2 epochs at 32², a fold of weight-standardised
    blocks with no norm, evaluated."""
    root = str(tmp_path / "qs")
    out = QS.main(["--root", root, "--epochs", "2", "--patients", "4",
                   "--dim", "32", "--ws", "--device", "cpu"])
    with open(os.path.join(out["exp"], "f0", "config", "config.json")) as fh:
        cfg = json.load(fh)
    assert cfg["WEIGHT_STANDARDISATION"] and cfg["WS_I_UNDERSTAND"]
    assert not cfg["BATCH_NORMALISATION"]
    with np.load(os.path.join(out["exp"], "f0", "model", "model.npz")) as z:
        keys = set(z.files)
    assert "params/DownBlock_0/ConvBlock_0/WSConv_0/gain" in keys
    assert not any("BatchNorm" in k or k.startswith("batch_stats")
                   for k in keys)
    assert len(pd.read_csv(out["df_eval"])) == 2


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    root = str(tmp_path / "qs")
    out = QS.main(["--root", root, "--epochs", "2", "--patients", "4",
                   "--dim", "32", "--tta", "--int8", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "=== localisation results (mm) ===" in printed
    df = pd.read_csv(out["df_eval"])
    assert len(df) == 2  # fold 0 tests 1 of 4 patients, ED and ES
    for col in QS.QUICK_COLS:
        assert out["means"][col] == pytest.approx(
            float(df[col].mean()), rel=STAT_RTOL, nan_ok=True)
        assert out["sd"][col] == pytest.approx(
            float(df[col].std()), rel=STAT_RTOL, nan_ok=True)
    for twin, suffix in (("tta", "_tta_coords"), ("int8", "_int8")):
        path = out[twin]["df_eval"][twin]
        assert path == os.path.join(out["exp"] + suffix, "df_eval.csv")
        assert len(pd.read_csv(path)) == 2
    with open(os.path.join(out["exp"] + "_int8", "f0", "config",
                           "config.json")) as fh:
        assert json.load(fh)["QUANT_INT8"] is True


def _df_eval(path):
    """A df_eval.csv with pathologies, an empty cell, a text cell and a
    row without a pathology."""
    rng = np.random.default_rng(0)
    cols = ["patient", "phase", "mdists_ant_gtpred", "mdists_inf_gtpred",
            "mdists_ant_gtpred_slice_wise", "tpr_ant", "ppv_ant", "tpr_inf",
            "ppv_inf", "tpr_ant_point_th15", "mdiffs_gtpred", "pathology"]
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(cols)
        for i in range(9):
            row = [f"patient{i:03d}", "ED" if i % 2 else "ES"]
            row += [repr(float(v)) for v in rng.gamma(2.0, 1.5, 3)]
            row += [repr(float(v)) for v in rng.random(5)]
            row += [repr(float(rng.normal(10, 3))),
                    ["DCM", "NOR", "HCM"][i % 3] if i != 8 else ""]
            if i == 2:
                row[2] = ""
            if i == 5:
                row[4] = "[1.0, 2.0]"
            writer.writerow(row)


def test_analyze_results_matches_cmrtpu(tmp_path, monkeypatch):
    df_path = str(tmp_path / "df_eval.csv")
    _df_eval(df_path)
    monkeypatch.setattr(sys, "argv", ["analyze_results.py", "--df", df_path,
                                      "--out", str(tmp_path / "ref")])
    _example("analyze_results").main()
    out = analyze_results.main(["--df", df_path,
                                "--out", str(tmp_path / "got")])
    with open(tmp_path / "ref" / "summary.csv", newline="") as a, \
            open(tmp_path / "got" / "summary.csv", newline="") as b:
        ref, got = list(csv.reader(a)), list(csv.reader(b))
    assert len(got) == len(ref) > 5 and got[0] == ref[0]
    for r, g in zip(ref[1:], got[1:]):
        assert (g[0], g[3]) == (r[0], r[3])  # metric, n
        for k in (1, 2):  # mean, sd
            assert float(g[k]) == pytest.approx(float(r[k]), rel=STAT_RTOL)
    df = pd.read_csv(df_path)
    for col in ("mdists_ant_gtpred", "mdists_inf_gtpred"):
        want = df.groupby("pathology")[col].agg(["mean", "std", "count"])
        got = out["per_pathology"][col]
        assert list(got) == list(want.index)
        for p, row in want.iterrows():
            assert got[p]["count"] == row["count"]
            for k in ("mean", "std"):
                assert got[p][k] == pytest.approx(row[k], rel=STAT_RTOL,
                                                  nan_ok=True)
    assert out["figures"]
    for name in ("violin_distances.png", "violin_detection.png",
                 "bland_altman.png"):
        assert os.path.getsize(tmp_path / "got" / name) > 0
        assert os.path.exists(tmp_path / "ref" / name)


def test_analyze_results_without_matplotlib(tmp_path, monkeypatch, caplog):
    df_path = str(tmp_path / "df_eval.csv")
    _df_eval(df_path)
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with caplog.at_level(logging.WARNING):
        out = analyze_results.main(["--df", df_path,
                                    "--out", str(tmp_path / "got")])
    assert not out["figures"]
    assert sorted(os.listdir(tmp_path / "got")) == ["summary.csv"]
    warned = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warned) == 1 and "skipped" in warned[0].getMessage()
    assert not math.isnan(out["summary"]["mean"][0])
