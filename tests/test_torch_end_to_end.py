"""cmrtpu_torch's whole user flow on the CPU, mirroring
tests/test_end_to_end.py: the port's make_dataset CLI builds the 2D dataset
from an ACDC-like tree, ``train_fold(device="cpu")`` trains fold 0 and chains
``pred_fold``, ``evaluate_cv`` writes df_eval.csv, and the predict and
evaluate_cv CLIs run on the result.

Parity with cmrtpu: both packages' ``pred_fold`` run on the fold's
model.npz (GAUS, SIGMA 1, CC_FILTER on; after 2 epochs both labels are
predicted on a fifth to a third of the pixels, in several components per
slice for the CC filter to choose from). The written label volumes are equal except at pixels whose cmrtpu probability
(pred) or heatmap (gt) lies within 1e-4 (pred) or 1e-5 (gt) of the 0.5
threshold, mapped into the written geometry; the cmr volumes within 1e-6;
and both packages' df_eval.csv on the trained tree are equal byte for
byte."""

import csv
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from cmrtpu_torch.cli import evaluate_cv as cli_eval
from cmrtpu_torch.cli import make_dataset as cli_md
from cmrtpu_torch.cli import predict as cli_predict
from cmrtpu_torch.data.dataset import fold_patients
from cmrtpu_torch.eval.evaluate import evaluate_cv
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.predict.predictor import pred_fold
from cmrtpu_torch.train.fold import train_fold

torch.set_num_threads(1)

SHAPE = (4, 36, 34)
SPACING = (1.4, 1.4, 8.0)
PRED_ATOL, GT_ATOL, CMR_ATOL = 1e-4, 1e-5, 1e-6

CFG = {"EXPERIMENT": "e2e", "DIM": [32, 32], "SPACING": [1.4, 1.4],
       "DEPTH": 2, "FILTERS": 4, "GROUP_NORM": 4, "MASK_VALUES": [1, 2],
       "MASK_CLASSES": 2, "BATCHSIZE": 4, "EPOCHS": 2, "RESAMPLE": True,
       "SHUFFLE": True, "MIXED_PRECISION": False, "LEARNING_RATE": 1e-3,
       "SEED": 42, "AUGMENT": False, "GAUS": True, "SIGMA": 1,
       "FOLDS": [0], "CC_FILTER": True, "GENERATOR_WORKER": 2,
       "SAVE_LEARNING_PROGRESS_AS_TF": False}


def _write_tree(root):
    """ACDC-like tree (Info.cfg, frames, ventricle gt, 4D cine) and the RVIP
    masks under io/, as tests/test_end_to_end.py builds it."""
    rng = np.random.default_rng(3)
    for i in range(1, 7):
        pid = f"patient{i:03d}"
        p = os.path.join(root, "original", pid)
        os.makedirs(p)
        with open(os.path.join(p, "Info.cfg"), "w") as fh:
            fh.write(f"ED: 1\nES: 12\nGroup: {['DCM', 'NOR'][i % 2]}\n")
        frames = []
        for frame in (1, 12):
            vol = rng.normal(300, 60, size=SHAPE).astype(np.float32)
            rvip = np.zeros(SHAPE, np.uint8)
            cy, cx = 10 + i % 3, 8 + i % 4
            vol[:, cy - 2:cy + 3, cx - 2:cx + 3] += 400
            vol[:, cy + 10:cy + 13, cx:cx + 3] += 400
            rvip[:, cy:cy + 2, cx:cx + 2] = 1
            rvip[:, cy + 10:cy + 12, cx:cx + 2] = 2
            stem = f"{pid}_frame{frame:02d}"
            write_image(MedicalImage(array=vol, spacing=SPACING),
                        os.path.join(p, f"{stem}.nii.gz"))
            gt = np.zeros(SHAPE, np.uint8)
            yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
            ring = np.hypot(yy - 18, xx - 22)
            gt[:, ring < 7] = 2
            gt[:, ring < 3] = 3
            gt[:, (np.hypot(yy - 18, xx - 10) < 6) & (ring >= 7)] = 1
            write_image(MedicalImage(array=gt, spacing=SPACING),
                        os.path.join(p, f"{stem}_gt.nii.gz"))
            write_image(MedicalImage(array=rvip, spacing=SPACING),
                        os.path.join(root, "io", f"{stem}_rvip.nrrd"))
            frames.append(vol)
        write_image(MedicalImage(array=np.stack(frames),
                                 spacing=SPACING + (1.0,)),
                    os.path.join(p, f"{pid}_4d.nii.gz"))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dataset"))
    os.makedirs(os.path.join(root, "io"))
    _write_tree(root)
    cli_md.cli(["-data_root", root, "-acdc_data",
                os.path.join(root, "original")])
    return root


def _fold_cfg(data_root, exp_root, **extra):
    return dict(CFG, EXP_PATH=exp_root, FOLD=0,
                DATA_PATH_SAX=os.path.join(data_root, "2D"),
                DF_FOLDS=os.path.join(data_root, "df_kfold.csv"),
                DATA_PATH_ORIG=os.path.join(data_root, "original"), **extra)


@pytest.fixture(scope="module")
def trained_exp(data_root, tmp_path_factory):
    exp_root = str(tmp_path_factory.mktemp("exp") / "run")
    train_fold(_fold_cfg(data_root, exp_root), device="cpu")
    return exp_root


def test_cli_make_dataset(data_root):
    slices = glob.glob(os.path.join(data_root, "2D", "*img.nrrd"))
    assert len(slices) == 6 * 2 * 4  # patients x phases x z
    with open(os.path.join(data_root, "df_kfold.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert list(rows[0]) == ["x_path", "y_path", "fold", "modality",
                             "patient", "pathology"]
    # min(4, patients) folds: 6 patients test in folds of 2, 2, 1 and 1
    assert [r["fold"] for r in rows][0] == "3"  # last fold first
    for fold, n_test in enumerate((2, 2, 1, 1)):
        test = fold_patients(os.path.join(data_root, "df_kfold.csv"), fold)
        train = fold_patients(os.path.join(data_root, "df_kfold.csv"), fold,
                              "train")
        assert len(test) == n_test and len(train) == 6 - n_test
        assert not set(test) & set(train)


def test_artifact_layout(trained_exp):
    fold_dir = os.path.join(trained_exp, "f0")
    for name in ("config/config.json", "model/model.npz",
                 "model_summary.txt", "history.csv", "fold_complete.json"):
        assert os.path.isfile(os.path.join(fold_dir, name)), name


def test_predictions_written_in_orig_geometry(trained_exp, data_root):
    fold_dir = os.path.join(trained_exp, "f0")
    preds = sorted(glob.glob(os.path.join(fold_dir, "pred", "*_msk.nrrd")))
    gts = sorted(glob.glob(os.path.join(fold_dir, "gt", "*_msk.nrrd")))
    cmrs = sorted(glob.glob(os.path.join(fold_dir, "pred", "*_cmr.nrrd")))
    test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
    assert [os.path.basename(p) for p in preds] == [
        f"{p}_{phase}_msk.nrrd" for p in test for phase in ("ED", "ES")]
    assert len(gts) == len(cmrs) == len(preds)
    for path in preds + gts + cmrs:
        img = read_image(path)
        assert img.array.shape == SHAPE
        np.testing.assert_allclose(img.spacing, SPACING, rtol=1e-5)
    gt = read_image(gts[0]).array
    assert set(np.unique(gt)) <= {0, 1, 2}
    assert (gt == 1).sum() > 0 and (gt == 2).sum() > 0


REF_COLUMNS = ("patient", "phase", "inplane_spacing", "ips_pred", "ips_gt",
               "mips_pred", "mangle_gt", "mdiffs_gtpred", "mdists_ant_gtpred",
               "mdists_inf_gtpred", "dists_ant_gtpred", "diffs_gtpred",
               "tpr_ant", "tpr_inf", "ppv_ant", "ppv_inf",
               "tpr_ant_point", "ppv_inf_point", "tpr_ant_point_th15",
               "ppv_inf_point_th15", "ips_pred_single_also",
               "mdists_ant_gtpred_single_also",
               "mdists_ant_gtpred_slice_wise",
               "mdists_ant_gtpred_slice_wise_up",
               "mdists_ant_gtpred_slice_wise_single_also_up", "EXP")


def test_evaluate_cv_writes_df_eval(trained_exp, data_root, tmp_path):
    from cmrtpu.eval.evaluate import evaluate_cv as jax_evaluate_cv

    cols = evaluate_cv(trained_exp, data_root)
    out = os.path.join(trained_exp, "df_eval.csv")
    with open(out) as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == len(cols["patient"]) == 4  # 2 patients x ED/ES
    for col in REF_COLUMNS + ("files_io", "files_orig_msk", "pathology",
                              "mdists_ant_gtio", "mdists_inf_gtorig"):
        assert col in rows[0], f"missing column {col}"
    assert {r["pathology"] for r in rows} <= {"DCM", "NOR"}
    assert min(len(ips[0]) for ips in cols["ips_gt"]) > 0
    # cmrtpu's evaluation of the same tree writes the same bytes
    ref = str(tmp_path / "ref.csv")
    jax_evaluate_cv(trained_exp, data_root, out_csv=ref)
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_cli_evaluate(trained_exp, data_root, capsys):
    cli_eval.main(["-exp", trained_exp, "-data", data_root])
    assert "evaluation done" in capsys.readouterr().out


def test_cli_predict_rewrites_outputs(trained_exp, data_root):
    fold_dir = os.path.join(trained_exp, "f0")
    before = {f: os.path.getmtime(f)
              for f in glob.glob(os.path.join(fold_dir, "pred", "*msk.nrrd"))}
    assert before
    cli_predict.main(["-exp", fold_dir, "-data", data_root,
                      "--device", "cpu"])
    after = {f: os.path.getmtime(f)
             for f in glob.glob(os.path.join(fold_dir, "pred", "*msk.nrrd"))}
    assert after.keys() == before.keys()
    assert any(after[f] > before[f] for f in after)


def test_pred_fold_device_default_is_cuda(trained_exp):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    cfg = json.load(open(os.path.join(trained_exp, "f0", "config",
                                      "config.json")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pred_fold(cfg)


def test_pred_fold_partial_orig_coverage(trained_exp, data_root, tmp_path):
    """Covered patients go back to the original geometry, the others stay
    on the model grid with the config-spacing header."""
    cfg = json.load(open(os.path.join(trained_exp, "f0", "config",
                                      "config.json")))
    covered, uncovered = fold_patients(cfg["DF_FOLDS"], 0)[:2]
    partial = tmp_path / "orig_partial"
    shutil.copytree(os.path.join(data_root, "original", covered),
                    str(partial / covered))
    out = str(tmp_path / "fold_out")
    assert pred_fold(dict(cfg, EXP_PATH=out, DATA_PATH_ORIG=str(partial)),
                     device="cpu")
    cov = read_image(os.path.join(out, "pred", f"{covered}_ED_msk.nrrd"))
    unc = read_image(os.path.join(out, "pred", f"{uncovered}_ED_msk.nrrd"))
    assert cov.array.shape == SHAPE
    np.testing.assert_allclose(cov.spacing, SPACING, rtol=1e-5)
    assert unc.array.shape[1:] == (32, 32)
    np.testing.assert_allclose(unc.spacing, (1.4, 1.4, 10.0), rtol=1e-5)


def _near_threshold(cfg, test_patients, atol_pred, atol_gt):
    """Per (patient, phase): uint8 volumes in the written geometry marking
    the pixels whose cmrtpu probability (pred) or heatmap (gt), in any
    channel, lies within the tolerance of 0.5 — recomputed with cmrtpu's
    own generator and predictor, as its pred_fold builds them."""
    from cmrtpu.data.dataset import get_trainings_files
    from cmrtpu.io import read_image as jax_read_image
    from cmrtpu.ops import resample as jr
    from cmrtpu.pipeline.generator import DataGenerator
    from cmrtpu.predict.postprocess import undo_generator_steps
    from cmrtpu.predict.predictor import Predictor, filter_by_patient_id

    _, _, x_val, y_val = get_trainings_files(cfg["DATA_PATH_SAX"], 0,
                                             cfg["DF_FOLDS"])
    predictor = Predictor(cfg)
    pred_cfg = dict(cfg, SHUFFLE=False, AUGMENT=False, BATCHSIZE=1,
                    HIST_MATCHING=False)
    out = {}
    for p in test_patients:
        files = filter_by_patient_id(p, x_val)
        masks = filter_by_patient_id(p, y_val)
        orig = jax_read_image(glob.glob(os.path.join(
            cfg["DATA_PATH_ORIG"], p, "*frame01.nii.gz"))[0])
        half = len(files) // 2
        for phase, sl in (("ED", slice(None, half)), ("ES", slice(half, None))):
            gen = DataGenerator(files[sl], masks[sl], config=pred_cfg)
            xs, ys = zip(*(gen[i] for i in range(len(gen))))
            x = np.concatenate([np.asarray(v) for v in xs])
            y = np.concatenate([np.asarray(v) for v in ys])
            probs = predictor.predict(x)
            for kind, vals, atol in (("pred", probs, atol_pred),
                                     ("gt", y, atol_gt)):
                near = (np.abs(vals - 0.5) <= atol).any(axis=-1)
                out[kind, p, phase] = undo_generator_steps(
                    near.astype(np.uint8), cfg, jr.NEAREST, orig).array > 0
    return out


def test_pred_fold_matches_cmrtpu(trained_exp, data_root, tmp_path):
    from cmrtpu.predict.predictor import pred_fold as jax_pred_fold

    fold_dir = os.path.join(trained_exp, "f0")
    cfg = json.load(open(os.path.join(fold_dir, "config", "config.json")))
    assert (cfg["GAUS"], cfg["SIGMA"], cfg["CC_FILTER"]) == (True, 1, True)
    assert cfg["MODEL_PATH"] == os.path.join(fold_dir, "model")
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_pred_fold(dict(cfg, EXP_PATH=jax_out))
    assert pred_fold(dict(cfg, EXP_PATH=torch_out), device="cpu")

    test = fold_patients(cfg["DF_FOLDS"], 0)
    near = _near_threshold(cfg, test, PRED_ATOL, GT_ATOL)
    labelled = 0
    for p in test:
        for phase in ("ED", "ES"):
            for sub, kind in (("pred", "pred"), ("gt", "gt")):
                name = os.path.join(sub, f"{p}_{phase}_msk.nrrd")
                ref = read_image(os.path.join(jax_out, name)).array
                got = read_image(os.path.join(torch_out, name)).array
                assert got.shape == ref.shape == SHAPE
                differ = got != ref
                assert not (differ & ~near[kind, p, phase]).any(), name
                labelled += int((ref > 0).sum()) if kind == "pred" else 0
            name = os.path.join("pred", f"{p}_{phase}_cmr.nrrd")
            np.testing.assert_allclose(
                read_image(os.path.join(torch_out, name)).array,
                read_image(os.path.join(jax_out, name)).array,
                atol=CMR_ATOL, rtol=0)
    assert labelled > 0  # the predictions are not all background


def test_pred_fold_3d_cc_matches_cmrtpu(trained_exp, tmp_path):
    """CC_FILTER '3d' on the same fold: both packages keep the biggest
    26-connected component per label in each patient-phase's volume and
    write the same label files, byte for byte, which differ from the
    per-slice filter's."""
    from cmrtpu.predict.predictor import pred_fold as jax_pred_fold

    fold_dir = os.path.join(trained_exp, "f0")
    cfg = json.load(open(os.path.join(fold_dir, "config", "config.json")))
    cfg["CC_FILTER"] = "3d"
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_pred_fold(dict(cfg, EXP_PATH=jax_out))
    assert pred_fold(dict(cfg, EXP_PATH=torch_out), device="cpu")
    kept, differs = 0, False
    for p in fold_patients(cfg["DF_FOLDS"], 0):
        for phase in ("ED", "ES"):
            name = os.path.join("pred", f"{p}_{phase}_msk.nrrd")
            with open(os.path.join(jax_out, name), "rb") as fh:
                want = fh.read()
            with open(os.path.join(torch_out, name), "rb") as fh:
                assert fh.read() == want, name
            volume = read_image(os.path.join(torch_out, name)).array
            kept += int((volume > 0).sum())
            differs |= bool((volume != read_image(os.path.join(
                fold_dir, name)).array).any())
    assert kept > 0 and differs
