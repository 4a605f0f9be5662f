"""cmrtpu_torch's evaluate_cv writes the same df_eval.csv as cmrtpu's, byte
for byte, on one seeded tree: pred, gt and cmr volumes of 4 patients x
ED/ES under an experiment root, RVIP masks under io/ (one patient missing,
for the rows without an inter-observer source), and the ACDC-like original/
tree with ventricle masks. Slices hold both labels, one label only, or
none. Cases: the timestamped layout with a complete ACDC tree; the flat
fold layout of a tree without ``*4d.nii.gz``, where both packages' pathology
join fails and leaves the column empty; and extra head families (a HEADS
model's ``_seg`` files), scored with one dice column per label: the ACDC
labels, other labels, a missing pair and a missing gt family."""

import glob
import os

import numpy as np
import pytest

from cmrtpu.eval.evaluate import evaluate_cv as jax_evaluate_cv
from cmrtpu_torch.eval.evaluate import evaluate_cv
from cmrtpu_torch.io import MedicalImage, write_image

SHAPE = (5, 40, 38)
SPACING = (1.3, 1.3, 8.0)
PATIENTS = (1, 2, 3, 11)
NO_IO = 3  # the patient without io/ masks


def _rvip(rng):
    """[z, y, x] labels: per slice both labels, label 1 only, label 2 only,
    or none, at jittered positions, sometimes with a second blob."""
    vol = np.zeros(SHAPE, np.uint8)
    for z in range(SHAPE[0]):
        kind = rng.integers(0, 4)
        for value in (1, 2):
            if kind == 3 or (kind == 1 and value == 2) \
                    or (kind == 2 and value == 1):
                continue
            y = rng.integers(4, SHAPE[1] - 6) if value == 1 else \
                rng.integers(20, SHAPE[1] - 4)
            x = rng.integers(4, SHAPE[2] - 6)
            vol[z, y:y + rng.integers(1, 4), x:x + rng.integers(1, 4)] = value
            if rng.random() < 0.3:
                vol[z, y - 3, x + 4] = value
    return vol


def _ventricles(rng):
    """LV / MYO / RV labels 3 / 2 / 1 with the RV touching the MYO ring."""
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
    vol = np.zeros(SHAPE, np.uint8)
    for z in range(SHAPE[0]):
        cy, cx = 20 + rng.integers(-2, 3), 23 + rng.integers(-2, 3)
        ring = np.hypot(yy - cy, xx - cx)
        vol[z][ring < 8] = 2
        vol[z][ring < 4] = 3
        vol[z][(np.hypot(yy - cy, xx - cx + 12) < 7) & (ring >= 8)] = 1
    if rng.random() < 0.5:
        vol[-1] = 0  # an apical slice with no ventricle
    return vol


def _write_tree(root, layout, with_4d):
    rng = np.random.default_rng(11)
    fold = os.path.join(root, "exp", *layout, "f0")
    for sub in ("pred", "gt"):
        os.makedirs(os.path.join(fold, sub))
    os.makedirs(os.path.join(root, "io"))
    for i in PATIENTS:
        pid = f"patient{i:03d}"
        folder = os.path.join(root, "original", pid)
        os.makedirs(folder)
        with open(os.path.join(folder, "Info.cfg"), "w") as fh:
            fh.write(f"ED: 1\nES: 12\nGroup: {['DCM', 'HCM', 'NOR'][i % 3]}\n"
                     "Height: 170.0\n")
        for frame, phase in ((1, "ED"), (12, "ES")):
            stem = f"{pid}_frame{frame:02d}"
            img = rng.normal(200, 30, SHAPE).astype(np.float32)
            write_image(MedicalImage(array=img, spacing=SPACING),
                        os.path.join(folder, f"{stem}.nii.gz"))
            write_image(MedicalImage(array=_ventricles(rng), spacing=SPACING),
                        os.path.join(folder, f"{stem}_gt.nii.gz"))
            if i != NO_IO:
                write_image(MedicalImage(array=_rvip(rng), spacing=SPACING),
                            os.path.join(root, "io", f"{stem}_rvip.nrrd"))
            for sub in ("pred", "gt"):
                write_image(MedicalImage(array=_rvip(rng), spacing=SPACING),
                            os.path.join(fold, sub, f"{pid}_{phase}_msk.nrrd"))
            write_image(MedicalImage(array=img, spacing=SPACING),
                        os.path.join(fold, "pred", f"{pid}_{phase}_cmr.nrrd"))
        if with_4d:
            write_image(MedicalImage(array=np.zeros((2,) + SHAPE, np.float32),
                                     spacing=SPACING + (1.0,)),
                        os.path.join(folder, f"{pid}_4d.nii.gz"))
    return os.path.join(root, "exp")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("layout,with_4d", [
    (("2026-01-01_00_00",), True), ((), False)],
    ids=["timestamped-acdc", "flat-no-4d"])
def test_df_eval_equals_cmrtpu(layout, with_4d, tmp_path):
    exp = _write_tree(str(tmp_path), layout, with_4d)
    ref, out = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    df = jax_evaluate_cv(exp, str(tmp_path), out_csv=ref)
    cols = evaluate_cv(exp, str(tmp_path), out_csv=out)
    assert list(cols) == list(df.columns)
    assert len(cols["patient"]) == 2 * len(PATIENTS)
    assert _read(out) == _read(ref)
    # the tree holds what the cases are about
    assert sum(v is None for v in cols["files_io"]) == 2
    pathology = set(cols["pathology"])
    assert pathology == ({"DCM", "HCM", "NOR"} if with_4d else {None})


@pytest.mark.parametrize("case", ["acdc", "two-labels", "pair-missing",
                                  "gt-missing"])
def test_extra_head_families_scored_like_cmrtpu(case, tmp_path):
    exp = _write_tree(str(tmp_path), ("2026-01-01_00_00",), True)
    rng = np.random.default_rng(13)
    labels = 3 if case != "two-labels" else 2
    preds = sorted(glob.glob(os.path.join(exp, "*", "*", "pred",
                                          "*_msk.nrrd")))
    for i, pred in enumerate(preds):
        gt = pred.replace(os.sep + "pred" + os.sep, os.sep + "gt" + os.sep)
        vol = rng.integers(0, labels + 1, SHAPE).astype(np.uint8)
        noisy = np.where(rng.random(SHAPE) < 0.2, 0, vol).astype(np.uint8)
        if case == "pair-missing" and i == 1:
            continue
        write_image(MedicalImage(array=noisy, spacing=SPACING),
                    pred.replace("_msk.nrrd", "_seg.nrrd"))
        if case != "gt-missing":
            write_image(MedicalImage(array=vol, spacing=SPACING),
                        gt.replace("_msk.nrrd", "_seg.nrrd"))
    ref, out = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    df = jax_evaluate_cv(exp, str(tmp_path), out_csv=ref)
    cols = evaluate_cv(exp, str(tmp_path), out_csv=out)
    assert list(cols) == list(df.columns)
    assert _read(out) == _read(ref)
    names = [c for c in cols if c.startswith("seg_dice_")]
    # without a gt file no pair is scored, and no dice column is written
    assert names == ({"two-labels": ["seg_dice_l1", "seg_dice_l2"],
                      "gt-missing": []}
                     .get(case, ["seg_dice_rv", "seg_dice_myo",
                                 "seg_dice_lv"]))
    assert "files_seg_gt" in cols
