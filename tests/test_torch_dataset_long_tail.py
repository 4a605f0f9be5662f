"""The long tail of ``cmrtpu_torch/data/dataset.py`` and the per-cine
generators of ``pipeline/generator.py:sliceable`` against cmrtpu's.

Both packages run on the same ACDC-like tree (9 patients in three
pathology groups, ED/ES frames with ventricle masks, a 4D cine each) and
on the same small 4D and 3D files. Files are compared by name and byte
for byte (the codecs are copies, so equal bytes mean equal arrays and
headers); tables as the port's rows against cmrtpu's
``DataFrame.to_dict("records")``, and the stratified CV table as its csv,
byte for byte against cmrtpu's ``to_csv(index=False)``; lists and strings
exactly. No tolerance: both sides run the same numpy code."""

import glob
import os

import numpy as np
import pandas as pd
import pytest
import torch

import cmrtpu.data.dataset as jd
import cmrtpu.io as jio
import cmrtpu_torch.data.dataset as td
from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
from cmrtpu.pipeline.generator import sliceable as jax_sliceable
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.pipeline.generator import DataGenerator, sliceable

torch.set_num_threads(1)

GROUPS = ("DCM", "NOR", "HCM")
SHAPE = (3, 12, 10)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """original/patientNNN/ with Info.cfg, ED/ES frames, their _gt masks
    and a 4D cine; 2D/ with the frames sliced."""
    root = tmp_path_factory.mktemp("acdc")
    rng = np.random.default_rng(7)
    for i in range(1, 10):
        pid = f"patient{i:03d}"
        p = root / "original" / pid
        p.mkdir(parents=True)
        (p / "Info.cfg").write_text(
            f"ED: 1\nES: 7\nGroup: {GROUPS[i % 3]}\nHeight: 170.0\n")
        for frame in (1, 7):
            stem = str(p / f"{pid}_frame{frame:02d}")
            write_image(MedicalImage(
                array=rng.normal(300, 60, SHAPE).astype(np.float32),
                spacing=(1.4, 1.3, 8.0)), stem + ".nii.gz")
            write_image(MedicalImage(
                array=rng.integers(0, 4, SHAPE).astype(np.uint8),
                spacing=(1.4, 1.3, 8.0)), stem + "_gt.nii.gz")
            td.create_2d_slices_from_3d_volume_files(
                stem + ".nii.gz", stem + "_gt.nii.gz", str(root / "2D"))
        write_image(MedicalImage(
            array=rng.normal(300, 60, (2, *SHAPE)).astype(np.float32),
            spacing=(1.4, 1.3, 8.0, 1.0), origin=(1.0, 2.0, 3.0, 0.0)),
            str(p / f"{pid}_4d.nii.gz"))
    return str(root)


def _pair_4d(tmp_path, name, t=3, direction=None):
    """A 4D image and a mask whose time steps 1 (4 slices) and 2 (2
    slices) are annotated."""
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(t, 4, 8, 9)).astype(np.float32)
    msk = np.zeros((t, 4, 8, 9), np.uint8)
    msk[1, :, 2:5, 2:5] = 1
    msk[2, :2, 1:3, 1:3] = 2
    geo = dict(spacing=(1.2, 1.1, 6.0, 1.0), origin=(4.0, -1.0, 2.0, 0.0))
    if direction is not None:
        geo["direction"] = direction
    img_f = str(tmp_path / f"{name}.nrrd")
    msk_f = str(tmp_path / f"{name}_m.nrrd")
    write_image(MedicalImage(array=vol, **geo), img_f)
    write_image(MedicalImage(array=msk, **geo), msk_f)
    return img_f, msk_f


def _same_rows(got, want):
    """Equal rows, key order included, NaN equal to NaN."""
    def norm(v):
        return "<nan>" if isinstance(v, float) and np.isnan(v) else v
    return [[(k, norm(v)) for k, v in r.items()] for r in got] == \
        [[(k, norm(v)) for k, v in r.items()] for r in want]


def _same_files(a, b, pattern="*"):
    """Both directories hold the same file names, each byte-equal."""
    names_a = sorted(os.path.relpath(f, a) for f in glob.glob(
        os.path.join(a, "**", pattern), recursive=True) if os.path.isfile(f))
    names_b = sorted(os.path.relpath(f, b) for f in glob.glob(
        os.path.join(b, "**", pattern), recursive=True) if os.path.isfile(f))
    assert names_a == names_b and names_a
    for name in names_a:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return names_a


@pytest.mark.parametrize("kind", ["4d", "3d"])
def test_4d_volume_file_slicer_matches(tree, tmp_path, kind):
    src = os.path.join(tree, "original", "patient002",
                       "patient002_4d.nii.gz" if kind == "4d"
                       else "patient002_frame07.nii.gz")
    got = td.create_2d_slices_from_4d_volume_file(src, str(tmp_path / "t"))
    want = jd.create_2d_slices_from_4d_volume_file(src, str(tmp_path / "j"))
    assert [os.path.basename(f) for f in got] == \
        [os.path.basename(f) for f in want]
    names = _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(names) == (2 * 3 if kind == "4d" else 3)


@pytest.mark.parametrize("filter_by_mask", [True, False])
def test_4d_pair_slicer_matches(tmp_path, filter_by_mask):
    tilted = (0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0,
              0.0, 0.0, 0.0, 1.0)
    img_f, msk_f = _pair_4d(tmp_path, "volume_cleanp42", direction=tilted)
    got = td.create_2d_slices_from_4d_volume_files(
        img_f, msk_f, str(tmp_path / "t"), filter_by_mask=filter_by_mask)
    want = jd.create_2d_slices_from_4d_volume_files(
        img_f, msk_f, str(tmp_path / "j"), filter_by_mask=filter_by_mask)
    assert got == want
    assert got[0] == ([1] if filter_by_mask else [0, 1, 2])
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("threshold", [0, 1, 2, 3])
def test_filter_4d_vol_matches(tmp_path, threshold):
    _, msk_f = _pair_4d(tmp_path, "p")
    nda = read_image(msk_f).array
    got, kept = td.filter_4d_vol(nda, threshold)
    want, kept_j = jd.filter_4d_vol(nda, threshold)
    assert kept == kept_j
    np.testing.assert_array_equal(got, want)


def test_any_filename_and_new_naming_match(tree, tmp_path):
    rng = np.random.default_rng(1)
    img_f, msk_f = (str(tmp_path / f"site1_p7_{k}.nrrd")
                    for k in ("img", "msk"))
    write_image(MedicalImage(array=rng.normal(size=(3, 8, 8)).astype(
        np.float32), spacing=(1.0, 1.1, 5.0)), img_f)
    write_image(MedicalImage(array=rng.integers(0, 3, (3, 8, 8)).astype(
        np.uint8), spacing=(1.0, 1.1, 5.0)), msk_f)
    assert td.create_2d_slices_from_3d_volume_files_any_filename(
        img_f, msk_f, str(tmp_path / "t")) == \
        jd.create_2d_slices_from_3d_volume_files_any_filename(
            img_f, msk_f, str(tmp_path / "j"))
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    folder = os.path.join(tree, "original", "patient004")
    for mask in (None, os.path.join(folder, "patient004_frame07_gt.nii.gz")):
        img = os.path.join(folder, "patient004_frame07.nii.gz")
        out = "new_none" if mask is None else "new_gt"
        assert td.create_2d_slices_from_3d_volume_files_new_naming(
            img, mask, str(tmp_path / out / "t")) == \
            jd.create_2d_slices_from_3d_volume_files_new_naming(
                img, mask, str(tmp_path / out / "j"))
        _same_files(str(tmp_path / out / "t"), str(tmp_path / out / "j"))


@pytest.mark.parametrize("threshold", [1, 2])
def test_3d_and_4d_volume_writers_match(tmp_path, threshold):
    img_f, msk_f = _pair_4d(tmp_path, "volume_cleanp9")
    assert td.create_3d_volumes_from_4d_files(
        img_f, msk_f, str(tmp_path / "t3"), threshold) == \
        jd.create_3d_volumes_from_4d_files(img_f, msk_f, str(tmp_path / "j3"),
                                           threshold)
    _same_files(str(tmp_path / "t3"), str(tmp_path / "j3"))
    assert td.create_4d_volumes_from_4d_files(
        img_f, msk_f, str(tmp_path / "t4"), threshold) == \
        jd.create_4d_volumes_from_4d_files(img_f, msk_f, str(tmp_path / "j4"),
                                           threshold)
    _same_files(str(tmp_path / "t4"), str(tmp_path / "j4"))


def test_split_4d_into_3d_matches(tmp_path):
    img_f, _ = _pair_4d(tmp_path, "p")
    got = td.split_4d_into_3d(read_image(img_f))
    want = jd.split_4d_into_3d(jio.read_image(img_f))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.array, w.array)
        assert (g.spacing, g.origin, g.direction) == \
            (w.spacing, w.origin, w.direction)


def test_volume_savers_match(tmp_path):
    rng = np.random.default_rng(2)
    gt = rng.integers(0, 2, (3, 2, 5, 6, 2)).astype(np.float32)
    pred = rng.random((3, 2, 5, 6, 2)).astype(np.float32)
    for pkg, out in ((td, "t"), (jd, "j")):
        base = str(tmp_path / out)
        pkg.save_3d(gt[0, ..., 0], os.path.join(base, "bare.nrrd"))
        pkg.save_phases(pred, base, "flow.nii")
        pkg.save_all_3d_vols_new([gt, pred], ["g.nii", "p.nii"], base,
                                 exp="vols")
        pkg.save_gt_and_pred(gt, pred, base, "patient009")
    names = _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    assert "gt_m/patient009_ES.nii" in names and "flow_2_.nii" in names


@pytest.mark.parametrize("make", [
    lambda: np.zeros((4, 8, 8), np.float32),
    lambda: MedicalImage(array=np.ones((2, 3, 5), np.uint8),
                         spacing=(1.5, 1.25, 7.0), origin=(1.0, 2.0, 3.0))])
def test_describe_image_matches(make):
    img = make()
    jimg = img if isinstance(img, np.ndarray) else jio.MedicalImage(
        array=img.array, spacing=img.spacing, origin=img.origin)
    assert td.describe_image(img) == jd.describe_image(jimg)


def test_acdc_descriptors_match(tree):
    original = os.path.join(tree, "original")
    for i in (1, 5):
        folder = os.path.join(original, f"patient{i:03d}")
        assert td.describe_acdc_patient_folder(folder) == \
            jd.describe_acdc_patient_folder(folder).to_dict("records")
        for t in (0, 1, 7, 100):
            assert td.get_phase_for_patient_timestep(folder, t) == \
                jd.get_phase_for_patient_timestep(folder, t)
    rows = td.get_acdc_dataset_as_df(original)
    want = jd.get_acdc_dataset_as_df(original)
    assert rows == want.to_dict("records") and len(rows) == 9 * 6
    assert list(rows[0]) == list(want.columns)
    assert td.get_acdc_pathologies(original) == dict(zip(want["patient"],
                                                         want["pathology"]))


@pytest.mark.parametrize("case", ["filtered", "unfiltered", "columns"])
def test_filter_x_by_patient_ids_matches(tree, case):
    x = sorted(glob.glob(os.path.join(tree, "2D", "*img.nrrd")))
    kw = {"filtered": {}, "unfiltered": {"filter": False},
          "columns": {"columns": ("patient", "x_path", "fold", "extra")}}[case]
    args = (x, ["patient002", "patient005"], "train")
    got = td.filter_x_by_patient_ids(*args, fold=3, pathology="NOR", **kw)
    want = jd.filter_x_by_patient_ids(*args, fold=3, pathology="NOR", **kw)
    assert _same_rows(got, want.to_dict("records"))
    assert list(got[0]) == list(want.columns)


@pytest.mark.parametrize("kfolds", [2, 3])
def test_stratified_cv_csv_matches(tree, tmp_path, kfolds):
    """The paper's folds: the csv bytes of cmrtpu's to_csv(index=False)."""
    args = (os.path.join(tree, "2D"), kfolds, os.path.join(tree, "original"))
    rows = td.create_acdc_dataframe_for_cv(*args)
    df = jd.create_acdc_dataframe_for_cv(*args)
    got, want = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    td.write_acdc_cv_csv(rows, got)
    df.to_csv(want, index=False)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert rows == df.to_dict("records")
    assert list(rows[0]) == sorted(rows[0]) == list(df.columns)
    # every pathology group in the test split of every fold
    for fold in range(kfolds):
        assert {r["pathology"] for r in rows if r["fold"] == fold
                and r["modality"] == "test"} == set(GROUPS)


def test_split_dir_helpers_match(tree, tmp_path):
    two_d, original = os.path.join(tree, "2D"), os.path.join(tree, "original")
    for path in (two_d, original):
        assert td.get_img_msk_files_from_split_dir(path) == \
            jd.get_img_msk_files_from_split_dir(path)
        assert td.get_patients(path) == jd.get_patients(path)
        assert td.load_acdc_files(path) == jd.load_acdc_files(path)
    assert len(td.get_patients(two_d)) == 9
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    vol = MedicalImage(array=np.zeros((2, 4, 4), np.float32))
    for name in ("a", "b"):
        write_image(vol, str(tmp_path / "images" / f"{name}_img.nrrd"))
        write_image(vol, str(tmp_path / "masks" / f"{name}_msk.nrrd"))
    for path in (str(tmp_path), original):
        assert td.get_3d_img_msk_files(path) == jd.get_3d_img_msk_files(path)


@pytest.mark.parametrize("name", ["patient042__t05_z3_img.nrrd",
                                  "f_patient001__tED_z12_msk.nrrd",
                                  "p42_t1_z0_img.nrrd"])
def test_position_helpers_match(name):
    assert td.get_z_position_from_filename(name) == \
        jd.get_z_position_from_filename(name)
    assert td.get_t_position_from_filename(name) == \
        jd.get_t_position_from_filename(name)


def _fold_rows(prefix, n):
    return [{"x_path": f"{prefix}{p:03d}__t01_z0_img.nrrd",
             "y_path": f"{prefix}{p:03d}__t01_z0_msk.nrrd", "fold": fold,
             "modality": "train" if p % 2 else "test",
             "patient": f"{prefix}{p:03d}", "pathology": "NOR"}
            for p in range(n) for fold in (0, 1)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_get_n_patients_matches(n):
    rows = _fold_rows("patient", 7)
    state = np.random.get_state()
    got = td.get_n_patients(rows, n)
    assert all(a == b for a, b in zip(np.random.get_state(), state)
               if not isinstance(a, np.ndarray))  # the global rng untouched
    assert got == jd.get_n_patients(pd.DataFrame(rows), n).to_dict("records")
    assert {r["modality"] for r in got} == {"train"}


@pytest.mark.parametrize("mix", [{}, {"n_first_df": 3},
                                 {"second": True, "n_second_df": 2},
                                 {"second": True, "n_second_df": 3,
                                  "fold": 1}])
def test_get_train_data_from_df_matches(tmp_path, mix):
    mix = dict(mix)
    first, second = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    pd.DataFrame(_fold_rows("patient", 6)).to_csv(first, index=False)
    pd.DataFrame(_fold_rows("gcn_", 5)).to_csv(second, index=False)
    if mix.pop("second", False):
        mix["second_df"] = second
    got = td.get_train_data_from_df(first, **mix)
    want = jd.get_train_data_from_df(first, **mix)
    assert got[:4] == tuple(list(w) for w in want[:4])
    assert got[4] == want[4]


def test_is_patient_in_df_matches():
    rows = [{"patient_unique": f"p{i}", "patient": f"q{i}"} for i in range(3)]
    df = pd.DataFrame(rows)
    for row in ({"patient_unique": "p1", "patient": "q0"},
                {"patient_unique": "p9", "patient": "q2"}):
        for col in ("patient_unique", "patient"):
            assert td.is_patient_in_df(row, rows, col) == \
                jd.is_patient_in_df(row, df, col)


def test_sliceable_matches(tree, tmp_path):
    """One generator per cine over its t x z slices: the same slice files
    and the same preprocessed cache as cmrtpu's generators."""
    files = sorted(glob.glob(os.path.join(tree, "original", "*",
                                          "*4d.nii.gz")))[:2]
    cfg = {"DIM": [16, 16], "SPACING": [1.4, 1.4], "RESAMPLE": True,
           "BATCHSIZE": 4, "GENERATOR_WORKER": 2}
    gens = sliceable(DataGenerator, files, config=cfg,
                     temp_path=str(tmp_path / "t"))
    refs = jax_sliceable(JaxGenerator, files, config=cfg,
                         temp_path=str(tmp_path / "j"))
    assert len(gens) == len(refs) == 2
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    for gen, ref in zip(gens, refs):
        assert [os.path.basename(f) for f in gen.images] == \
            [os.path.basename(f) for f in ref.images]
        assert gen._cache_x.shape == (2 * 3, 16, 16)
        np.testing.assert_array_equal(gen._cache_x, ref._cache_x)
        np.testing.assert_array_equal(gen._cache_y, ref._cache_y)
