"""``cmrtpu_torch/eval/file_metrics.py`` and ``evaluate.evaluate_cv_save``
against cmrtpu's.

The same mask files — RVIP label volumes (1 anterior, 2 inferior, some
slices with one landmark or none) and ventricle masks (RV 1, MYO 2, LV 3)
— go through both packages' functions: distances, angles and their table
rows equal cmrtpu's, NaN for NaN, with no tolerance (both sides run the
same numpy code over copies of the landmark module). ``evaluate_cv_save``
on one experiment tree writes the same ``df_eval.csv`` bytes as cmrtpu's:
with every source, with a source skipped for its file count, with the
pathology join failed, in the nested and the flat fold layout; both raise
when every source is skipped."""

import glob
import os
import shutil

import numpy as np
import pytest

import cmrtpu.eval.evaluate as JE
import cmrtpu.eval.file_metrics as JF
import cmrtpu_torch.eval.evaluate as TE
import cmrtpu_torch.eval.file_metrics as TF
from cmrtpu_torch.io import MedicalImage, write_image

SHAPE = (4, 40, 38)
SPACING = (1.4, 1.4, 8.0)


def _rvip(rng, drop=()):
    """RVIP labels: per slice a 2x2 anterior and inferior blob near fixed
    points, jittered; slices in ``drop`` lose a landmark or both."""
    m = np.zeros(SHAPE, np.uint8)
    for z in range(SHAPE[0]):
        ay, ax = 12 + rng.integers(-2, 3), 10 + rng.integers(-2, 3)
        iy, ix = 26 + rng.integers(-2, 3), 12 + rng.integers(-2, 3)
        if z not in drop or drop[z] == "inf":
            m[z, ay:ay + 2, ax:ax + 2] = 1
        if z not in drop or drop[z] == "ant":
            m[z, iy:iy + 2, ix:ix + 2] = 2
    return m


def _ventricles(shift=0):
    """LV ring with a crescent RV beside it, so the contour walk finds both
    insertion points."""
    gt = np.zeros(SHAPE, np.uint8)
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
    ring = np.hypot(yy - 20, xx - 24 - shift)
    gt[:, ring < 8] = 2
    gt[:, ring < 4] = 3
    gt[:, (np.hypot(yy - 20, xx - 11 - shift) < 7) & (ring >= 8)] = 1
    gt[-1] = 0  # a slice without the heart
    return gt


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("masks")
    rng = np.random.default_rng(11)
    out = {}
    for name, arr in (
            ("gt", _rvip(rng)),
            ("pred", _rvip(rng, {1: "ant", 3: "both"})),
            ("sparse", _rvip(rng, {0: "both", 1: "both", 2: "inf",
                                   3: "both"})),
            ("empty", np.zeros(SHAPE, np.uint8)),
            ("vent", _ventricles()),
            ("vent2", _ventricles(shift=2))):
        path = str(root / f"{name}.nrrd")
        write_image(MedicalImage(array=arr, spacing=SPACING), path)
        out[name] = path
    return out


def _norm(values):
    return [("<nan>" if isinstance(v, float) and np.isnan(v) else v)
            for v in np.asarray(values, dtype=object).ravel()]


PAIRS = [("gt", "pred", False, False), ("gt", "sparse", False, False),
         ("gt", "empty", False, False), ("gt", "vent", False, True),
         ("vent", "vent2", True, True)]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("meanips", [False, True])
def test_distances_match(files, pair, meanips):
    from cmrtpu_torch.io import read_image
    a, b, am, bm = pair
    va, vb = read_image(files[a]).array, read_image(files[b]).array
    got = TF.calc_distances(va, vb, am, bm, usemeanips=meanips)
    want = JF.calc_distances(va, vb, am, bm, usemeanips=meanips)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _norm(g) == _norm(w)
    for physical in (False, True):
        assert _norm(TF.calc_dist_files(files[a], files[b], am, bm, physical,
                                        meanips)) == \
            _norm(JF.calc_dist_files(files[a], files[b], am, bm, physical,
                                     meanips))


@pytest.mark.parametrize("name", ["gt", "sparse", "empty", "vent"])
@pytest.mark.parametrize("meanips", [False, True])
def test_angles_match(files, name, meanips):
    from cmrtpu_torch.io import read_image
    ismsk = name.startswith("vent")
    vol = read_image(files[name]).array
    assert _norm(TF.calc_angles2x(vol, ismsk, meanips)) == \
        _norm(JF.calc_angles2x(vol, ismsk, meanips))
    assert _norm(TF.calc_mean_angle(files[name], ismsk, meanips)) == \
        _norm(JF.calc_mean_angle(files[name], ismsk, meanips))
    assert _norm(TF.calc_mean_angle_diff(files["gt"], files[name], False,
                                         ismsk, meanips)) == \
        _norm(JF.calc_mean_angle_diff(files["gt"], files[name], False,
                                      ismsk, meanips))


@pytest.mark.parametrize("point", [None, (1.0, 2.0), (np.nan, 2.0),
                                   np.array([3.0, 4.0])])
def test_isvalid_matches(point):
    assert TF.isvalid(point) == JF.isvalid(point)


@pytest.mark.parametrize("f2ismsk", [False, True])
@pytest.mark.parametrize("meanips", [False, True])
def test_tables_match(files, f2ismsk, meanips):
    ones = [files["gt"], files["gt"], files["vent"]]
    twos = [files["vent"], files["vent2"], files["vent2"]] if f2ismsk \
        else [files["pred"], files["sparse"], files["empty"]]
    for port, ref in ((TF.get_angles_as_df, JF.get_angles_as_df),
                      (TF.get_dist_as_df, JF.get_dist_as_df)):
        got = port(ones, twos, f2ismsk=f2ismsk, suffix="io", meanips=meanips)
        want = ref(ones, twos, f2ismsk=f2ismsk, suffix="io",
                   meanips=meanips).to_dict("records")
        assert [list(r) for r in got] == [list(r) for r in want]
        assert [_norm(list(r.values())) for r in got] == \
            [_norm(list(r.values())) for r in want]


def _tree(root, layout):
    """An experiment tree (three patients' ED/ES prediction and gt RVIP
    files) and its data root (io/ RVIP files, original/ ACDC folders with
    ventricle masks, Info.cfg and 4D files)."""
    rng = np.random.default_rng(5)
    data = os.path.join(root, "data")
    fold = os.path.join(root, "exp", *(("2026", "f0") if layout == "nested"
                                       else ("f0",)))
    for sub in ("pred", "gt"):
        os.makedirs(os.path.join(fold, sub))
    os.makedirs(os.path.join(data, "io"))
    for i, pid in enumerate(("patient003", "patient011", "patient020")):
        folder = os.path.join(data, "original", pid)
        os.makedirs(folder)
        with open(os.path.join(folder, "Info.cfg"), "w") as fh:
            fh.write(f"ED: 1\nES: 9\nGroup: {('DCM', 'NOR')[i % 2]}\n")
        for phase, frame in (("ED", 1), ("ES", 9)):
            stem = f"{pid}_frame{frame:02d}"
            gt = _rvip(rng)
            drop = {i % 4: "ant"} if phase == "ES" else {}
            for sub, arr in (("gt", gt), ("pred", _rvip(rng, drop))):
                write_image(MedicalImage(array=arr, spacing=SPACING),
                            os.path.join(fold, sub, f"{pid}_{phase}_msk.nrrd"))
            write_image(MedicalImage(array=_rvip(rng), spacing=SPACING),
                        os.path.join(data, "io", f"{stem}_rvip.nrrd"))
            write_image(MedicalImage(array=np.zeros(SHAPE, np.float32),
                                     spacing=SPACING),
                        os.path.join(folder, f"{stem}.nii.gz"))
            write_image(MedicalImage(array=_ventricles(shift=i),
                                     spacing=SPACING),
                        os.path.join(folder, f"{stem}_gt.nii.gz"))
        write_image(MedicalImage(array=np.zeros((2, *SHAPE), np.float32),
                                 spacing=SPACING + (1.0,)),
                    os.path.join(folder, f"{pid}_4d.nii.gz"))
    return os.path.join(root, "exp"), data, fold


@pytest.mark.parametrize("layout", ["nested", "flat"])
@pytest.mark.parametrize("case", ["all", "skip_io", "no_pathology",
                                  "skip_orig"])
def test_evaluate_cv_save_matches(tmp_path, layout, case, caplog):
    exp, data, fold = _tree(str(tmp_path), layout)
    if case == "skip_io":
        os.remove(glob.glob(os.path.join(data, "io", "*"))[0])
    elif case == "no_pathology":
        os.remove(os.path.join(data, "original", "patient011",
                               "patient011_4d.nii.gz"))
    elif case == "skip_orig":  # a third annotated frame
        shutil.copy(os.path.join(data, "original", "patient020",
                                 "patient020_frame09_gt.nii.gz"),
                    os.path.join(data, "original", "patient020",
                                 "patient020_frame05_gt.nii.gz"))
    ref = JE.evaluate_cv_save(exp, data)
    with open(os.path.join(exp, "df_eval.csv"), "rb") as fh:
        want = fh.read()
    os.remove(os.path.join(exp, "df_eval.csv"))
    caplog.clear()
    rows = TE.evaluate_cv_save(exp, data)
    with open(os.path.join(exp, "df_eval.csv"), "rb") as fh:
        assert fh.read() == want
    assert len(rows) == len(ref) == 6
    assert list(rows[0]) == list(ref.columns)
    assert list(rows[0]).count("gt_angle") == 1
    pathology = [r["pathology"] for r in rows]
    if case == "no_pathology":
        assert pathology == [None] * 6 and "pathology join" in caplog.text
    else:
        assert pathology == ["DCM"] * 2 + ["NOR"] * 2 + ["DCM"] * 2
    skipped = {"skip_io": "io", "skip_orig": "orig_msk"}.get(case)
    for src in ("io", "orig_msk"):
        assert (f"ant_dist_{src}" in rows[0]) == (src != skipped)
    if skipped:
        assert f"skip source '{skipped}'" in caplog.text
    assert np.isfinite([r["ant_dist_pred"] for r in rows]).all()


def test_evaluate_cv_save_raises_when_every_source_is_skipped(tmp_path):
    exp, data, fold = _tree(str(tmp_path), "flat")
    os.remove(os.path.join(fold, "gt", "patient003_ED_msk.nrrd"))
    for fn in (JE.evaluate_cv_save, TE.evaluate_cv_save):
        with pytest.raises(FileNotFoundError, match="every source"):
            fn(exp, data)
    shutil.rmtree(os.path.join(fold, "pred"))
    for fn in (JE.evaluate_cv_save, TE.evaluate_cv_save):
        with pytest.raises(FileNotFoundError, match="no prediction masks"):
            fn(exp, data)
