"""The port's own copies of cmrtpu's numpy-only host modules stay equal to
their sources: one case per copied module, on the same seeded inputs.

Configs compare as equal dicts, files written with the native codec byte
for byte (and each package reads the other's files), arrays exactly (the
copies run the same numpy code), with the native codec and with its
pure-Python path. The evaluation's copies (contours, landmarks) give equal
results; the dataset functions write the same 2D slices and, without pandas
or scikit-learn, the same df_kfold.csv bytes; the phantom cohort of the
port's full_cv_demo tool and its per-slice ``_seg`` targets are the same as
examples/full_cv_demo.py's; the evaluation's ``dice_numpy`` gives equal
scores."""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest

import cmrtpu.config as jc
import cmrtpu.data.dataset as jd
import cmrtpu.eval.contours as jcont
import cmrtpu.eval.landmarks as jlm
import cmrtpu.io as jio
import cmrtpu.native.cmrio as jcmrio
import cmrtpu.ops.resample as jr
import cmrtpu.pipeline.transforms as jt
import cmrtpu.predict.postprocess as jpp
import cmrtpu.utils.io_utils as jutil
import cmrtpu.utils.tfevents as jtf
import cmrtpu_torch.config as tc
import cmrtpu_torch.data.dataset as td
import cmrtpu_torch.eval.contours as tcont
import cmrtpu_torch.eval.landmarks as tlm
import cmrtpu_torch.tools.full_cv_demo as tdemo
import cmrtpu_torch.io as tio
import cmrtpu_torch.native.cmrio as tcmrio
import cmrtpu_torch.ops.resample as tr
import cmrtpu_torch.pipeline.transforms as tt
import cmrtpu_torch.predict.postprocess as tpp
import cmrtpu_torch.utils.io_utils as tutil
import cmrtpu_torch.utils.tfevents as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "exp", "template_cfgs", "gaus_sigma2_config.json")


def _config(tmp_path):
    with open(FLAGSHIP) as fh:
        raw = json.load(fh)
    assert "REDUCE_LR_ON_PLAEAU_PATIENCE" in raw  # the aliased typo
    assert tc.normalise_config(raw) == jc.normalise_config(raw)
    assert tc.DEFAULTS == jc.DEFAULTS
    for fold in (None, 2):
        assert tc.set_experiment_paths(raw, str(tmp_path), fold) == \
            jc.set_experiment_paths(raw, str(tmp_path), fold)
    assert tc.timestamped_exp_path(raw, "2026-01-01_00_00") == \
        jc.timestamped_exp_path(raw, "2026-01-01_00_00")
    assert tc.get(raw, "REDUCE_LR_ON_PLATEAU_PATIENCE") == 5
    saved = []
    for pkg in (tc, jc):
        cfg = pkg.init_config(dict(raw, EXP_PATH=str(tmp_path / pkg.__name__),
                                   FOLD=0))
        with open(os.path.join(cfg["CONFIG_PATH"], "config.json")) as fh:
            saved.append({k: v for k, v in json.load(fh).items()
                          if not k.endswith("_PATH")})
    assert saved[0] == saved[1]


def _image(seed, shape=(4, 20, 22), dtype=np.float32):
    rng = np.random.default_rng(seed)
    arr = (rng.normal(size=shape) * 100).astype(dtype)
    return arr, dict(spacing=(1.5, 1.25, 8.0), origin=(3.0, -2.0, 10.0))


def _io(tmp_path):
    for ext, dtype in ((".nrrd", np.float32), (".nii.gz", np.float32),
                       (".nrrd", np.uint8), (".nii.gz", np.int16)):
        arr, geo = _image(1, dtype=dtype)
        paths = {}
        for name, pkg in (("port", tio), ("ref", jio)):
            paths[name] = str(tmp_path / f"{name}_{dtype.__name__}{ext}")
            pkg.write_image(pkg.MedicalImage(array=arr, **geo), paths[name])
        if tcmrio.get_library() is not None:
            # the pure-Python gzip path stamps the current second into its
            # header, so only the native codec's files compare byte for byte
            with open(paths["port"], "rb") as a, \
                    open(paths["ref"], "rb") as b:
                assert a.read() == b.read(), ext
        for reader, path in ((tio, paths["ref"]), (jio, paths["port"])):
            img = reader.read_image(path)
            np.testing.assert_array_equal(img.array, arr)
            np.testing.assert_allclose(img.spacing, geo["spacing"])
            np.testing.assert_allclose(img.origin, geo["origin"])
    blob = np.random.default_rng(6).bytes(4096) + bytes(4096)
    assert tcmrio.inflate(tcmrio.deflate_gzip(blob)) == blob
    assert jcmrio.inflate(tcmrio.deflate_gzip(blob)) == blob
    assert tcmrio.inflate_batch([jcmrio.deflate_gzip(blob)] * 3) == [blob] * 3


def _resample_transforms(tmp_path):
    arr, geo = _image(2)
    for interp in (tr.LINEAR, tr.NEAREST):
        np.testing.assert_array_equal(
            tr.resample_nd(arr, geo["spacing"], (30, 16, 5), (1.0, 1.7, 6.0),
                           interp),
            jr.resample_nd(arr, geo["spacing"], (30, 16, 5), (1.0, 1.7, 6.0),
                           interp))
    img_t = tr.resample_image(tio.MedicalImage(array=arr, **geo), (30, 16, 5),
                              (1.0, 1.7, 6.0), tr.LINEAR)
    img_j = jr.resample_image(jio.MedicalImage(array=arr, **geo), (30, 16, 5),
                              (1.0, 1.7, 6.0), jr.LINEAR)
    np.testing.assert_array_equal(img_t.array, img_j.array)
    assert img_t.spacing == img_j.spacing
    np.testing.assert_array_equal(tt.clip_quantile(arr, 0.99),
                                  jt.clip_quantile(arr, 0.99))
    for scaler in ("MinMax", "Standard", "Robust"):
        np.testing.assert_array_equal(tt.normalise_image(arr, scaler),
                                      jt.normalise_image(arr, scaler))
    for target in ((4, 16, 30), (6, 21, 21)):
        np.testing.assert_array_equal(tt.pad_and_crop(arr, target),
                                      jt.pad_and_crop(arr, target))
    assert tt.calc_resampled_size((22, 20, 4), geo["spacing"], (1.2, 1.2, 8)) \
        == jt.calc_resampled_size((22, 20, 4), geo["spacing"], (1.2, 1.2, 8))


def _postprocess(tmp_path):
    arr, geo = _image(3)
    pred = (np.random.default_rng(4).random((4, 24, 24)) * 3).astype(np.uint8)
    cfg = {"DIM": [24, 24], "SPACING": [1.2, 1.2]}
    got = tpp.undo_generator_steps(pred, cfg, tr.NEAREST,
                                   tio.MedicalImage(array=arr, **geo))
    ref = jpp.undo_generator_steps(pred, cfg, jr.NEAREST,
                                   jio.MedicalImage(array=arr, **geo))
    np.testing.assert_array_equal(got.array, ref.array)
    assert (got.spacing, got.origin, got.direction) == \
        (ref.spacing, ref.origin, ref.direction)


def _utils(tmp_path):
    for pkg, name in ((tutil, "port"), (jutil, "ref")):
        pkg.ensure_dir(str(tmp_path / name / "a" / "b"))
        pkg.ensure_dir(str(tmp_path / name / "a" / "b"))  # idempotent
        assert (tmp_path / name / "a" / "b").is_dir()
    assert ttf.crc32c(b"123456789") == jtf.crc32c(b"123456789") == 0xE3069283
    rgb = np.random.default_rng(5).integers(0, 255, (6, 7, 3), np.uint8)
    assert ttf.encode_png_rgb(rgb) == jtf.encode_png_rgb(rgb)
    writer = ttf.EventWriter(str(tmp_path / "tb"))
    writer.add_scalar("loss", 0.5, 1)
    writer.close()
    assert os.path.getsize(writer._path) > 0


@pytest.mark.parametrize("check", [_config, _io, _resample_transforms,
                                   _postprocess, _utils],
                         ids=["config", "io+native", "resample+transforms",
                              "postprocess", "io_utils+tfevents"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_copy_matches_cmrtpu(check, native, tmp_path, monkeypatch):
    if not native:
        # both packages' codecs fall back to their pure-Python paths
        monkeypatch.setenv("CMRTPU_DISABLE_NATIVE", "1")
        for build in ("cmrtpu.native.build", "cmrtpu_torch.native.build"):
            monkeypatch.setattr(f"{build}._lib", None)
            monkeypatch.setattr(f"{build}._failed", False)
    check(tmp_path)


def _same_file(a, b):
    """Byte-equal with the native codec; with the pure-Python gzip path
    (which stamps the current second into its header) equal arrays and
    geometry."""
    if tcmrio.get_library() is not None:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()
    ia, ib = tio.read_image(a), tio.read_image(b)
    return np.array_equal(ia.array, ib.array) and \
        (ia.spacing, ia.origin, ia.direction) == \
        (ib.spacing, ib.origin, ib.direction)


def _ventricle_masks():
    """Phantom LV/MYO/RV slices of the demo cohort, and the degenerate
    cases: empty, MYO only, RV without MYO."""
    rng = np.random.default_rng(8)
    masks = [tdemo._slice_phantom(64, (32 + rng.integers(-3, 4),
                                       32 + rng.integers(-3, 4)),
                                  rng.uniform(6, 9), rng.uniform(2, 4),
                                  rng.uniform(-0.5, 0.5), rng.uniform(6, 9),
                                  rng)[1]
             for _ in range(6)]
    blank = np.zeros((64, 64), np.uint8)
    myo = blank.copy()
    myo[20:30, 20:30] = 2
    rv = blank.copy()
    rv[5:9, 5:9] = 1
    return np.stack(masks + [blank, myo, rv])


def test_contours_and_landmarks_match_cmrtpu():
    rng = np.random.default_rng(7)
    for density in (0.1, 0.3, 0.6):
        mask = rng.random((23, 31)) < density
        assert tcont.find_external_contours(mask) == \
            jcont.find_external_contours(mask)
    rvip = np.zeros((6, 30, 28), np.uint8)
    for z in range(5):  # the last slice stays empty
        for value in (1, 2)[:1 + z % 2]:
            y, x = rng.integers(0, 26, 2)
            rvip[z, y:y + 3, x:x + 2] = value
    for both_only in (True, False):
        for keepdim in (True, False):
            assert tlm.get_ip_from_rvip_mask_3d(
                rvip, keepdim=keepdim, both_only=both_only) == \
                jlm.get_ip_from_rvip_mask_3d(
                    rvip, keepdim=keepdim, both_only=both_only)
    vent = _ventricle_masks()
    found = [tlm.get_ip_from_2dmask(nda) for nda in vent]
    assert sum(a is not None and b is not None for a, b in found) == 6
    for nda in vent:
        for rev in (False, True):
            assert tlm.get_ip_from_2dmask(nda, rev=rev) == \
                jlm.get_ip_from_2dmask(nda, rev=rev)
    assert tlm.get_ip_from_mask_3d(vent, keepdim=True, rev=True) == \
        jlm.get_ip_from_mask_3d(vent, keepdim=True, rev=True)


def test_landmark_metrics_match_cmrtpu():
    rng = np.random.default_rng(9)

    def ips(n):
        return tuple([None if rng.random() < 0.3 else
                      [float(v) for v in rng.uniform(0, 60, 2)]
                      for _ in range(n)] for _ in range(2))

    gt, pred = ips(12), ips(12)
    np.testing.assert_array_equal(tlm.get_angles2x(gt), jlm.get_angles2x(gt))
    for a, b in zip(gt[0] + [[1.0, np.nan]], pred[1] + [[2.0, 3.0]]):
        assert tlm.get_angle2x(a, b) == jlm.get_angle2x(a, b)
        assert tlm.get_dist(a, b) == jlm.get_dist(a, b) or \
            np.isnan(tlm.get_dist(a, b))
    for pair in (gt, str(gt)):
        t, j = tlm.calc_mean_ip(pair), jlm.calc_mean_ip(pair)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
    for threshold in (None, 20.0):
        for t, j in zip(tlm.get_distances(gt, pred, 1.3, threshold),
                        jlm.get_distances(gt, pred, 1.3, threshold)):
            np.testing.assert_array_equal(t, j)
            assert tlm.get_mean_dist(t) == jlm.get_mean_dist(j)
    for t, j in zip(tlm.get_distances_upper_bound(gt, pred, 1.3, 64),
                    jlm.get_distances_upper_bound(gt, pred, 1.3, 64)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tlm.get_differences(tlm.get_angles2x(gt), tlm.get_angles2x(pred)),
        jlm.get_differences(jlm.get_angles2x(gt), jlm.get_angles2x(pred)))
    for kw in ({}, {"thresh": 15, "spacing": 1.3}, {"thresh": 1e-3}):
        for fn in ("calc_tpr_thresh", "calc_ppv_thresh"):
            for g, p in ((gt, pred), (str(gt), str(pred)), (gt, gt)):
                assert getattr(tlm, fn)(g, p, **kw) == \
                    getattr(jlm, fn)(g, p, **kw)


def test_dataset_functions_match_cmrtpu(tmp_path):
    rng = np.random.default_rng(10)
    acdc = tmp_path / "original" / "patient007"
    acdc.mkdir(parents=True)
    (acdc / "Info.cfg").write_text("ED: 1\nES: 9\nGroup: MINF\n"
                                   "Height: 184.0\nNbFrame: 30\n")
    geo = dict(spacing=(1.5, 1.5, 10.0), origin=(1.0, 2.0, 3.0))
    for frame in ("01", "09"):
        for tail, arr in (("", rng.normal(size=(3, 12, 14)).astype(np.float32)),
                          ("_gt", rng.integers(0, 4, (3, 12, 14), np.uint8))):
            tio.write_image(tio.MedicalImage(array=arr, **geo), str(
                acdc / f"patient007_frame{frame}{tail}.nii.gz"))
    rvip = str(tmp_path / "patient007_frame01_rvip.nrrd")
    tio.write_image(tio.MedicalImage(array=rng.integers(0, 3, (3, 12, 14),
                                                        np.uint8), **geo), rvip)
    img = str(acdc / "patient007_frame01.nii.gz")
    for mask in (rvip, None):
        got = td.create_2d_slices_from_3d_volume_files(
            img, mask, str(tmp_path / "port"))
        want = jd.create_2d_slices_from_3d_volume_files(
            img, mask, str(tmp_path / "ref"))
        assert [os.path.basename(f) for f in got] == \
            [os.path.basename(f) for f in want]
        names = sorted(os.listdir(tmp_path / "ref"))
        assert names == sorted(os.listdir(tmp_path / "port")) and names
        for name in names:
            assert _same_file(str(tmp_path / "port" / name),
                              str(tmp_path / "ref" / name)), name

    cfg = str(acdc / "Info.cfg")
    assert td.read_cfg_file(cfg) == jd.read_cfg_file(cfg)
    for phase in ("ED", "ES"):
        for gt in (False, True):
            assert td.get_phase_file(str(acdc), phase, gt) == \
                jd.get_phase_file(str(acdc), phase, gt)
    assert td.get_pathology_group(str(acdc)) == \
        jd.get_pathology_group(str(acdc)) == "MINF"

    # the pathology join: equal where cmrtpu's table builds, raising where
    # it raises (a folder without *4d.nii.gz, a tree without folders)
    original = str(tmp_path / "original")
    with pytest.raises(IndexError):
        jd.get_acdc_dataset_as_df(original)
    with pytest.raises(IndexError):
        td.get_acdc_pathologies(original)
    tio.write_image(tio.MedicalImage(array=np.zeros((2, 3, 12, 14),
                                                    np.float32)),
                    str(acdc / "patient007_4d.nii.gz"))
    df = jd.get_acdc_dataset_as_df(original)
    assert td.get_acdc_pathologies(original) == dict(
        df.drop_duplicates("patient")[["patient", "pathology"]].values)
    with pytest.raises(ValueError):
        jd.get_acdc_dataset_as_df(str(tmp_path / "none"))
    with pytest.raises(ValueError):
        td.get_acdc_pathologies(str(tmp_path / "none"))


@pytest.mark.parametrize("n,k", [(6, 2), (8, 4), (9, 4), (100, 4)])
def test_kfold_csv_matches_cmrtpu(n, k, tmp_path):
    from sklearn.model_selection import KFold

    two_d = tmp_path / "2D"
    two_d.mkdir()
    for p in range(n):
        for z in range(2):
            for kind in ("img", "msk"):
                (two_d / f"patient{p:03d}__t01_z{z}_{kind}.nrrd").touch()
    splits = list(KFold(k, shuffle=True, random_state=42).split(range(n)))
    for (tr, te), (want_tr, want_te) in zip(td.kfold_split(n, k), splits):
        np.testing.assert_array_equal(tr, want_tr)
        np.testing.assert_array_equal(te, want_te)
    ref, port = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    jd.get_kfolded_data(kfolds=k, path_to_data=str(two_d)).to_csv(
        ref, index=False)
    td.write_kfold_csv(td.get_kfolded_data(kfolds=k,
                                           path_to_data=str(two_d)), port)
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert a.read() == b.read()
    for fold in range(k):  # the port's reader of the table it wrote
        x_tr, _, x_te, _ = td.get_trainings_files(str(two_d), fold, port)
        assert len(x_tr) + len(x_te) == 2 * n
        assert {td.get_patient(f) for f in x_te} == \
            set(td.fold_patients(port, fold))


def test_demo_cohort_matches_example(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "full_cv_demo_example", os.path.join(REPO, "examples",
                                             "full_cv_demo.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    kw = dict(n_patients=3, hw=64, n_slices=3, spacing=1.3, seed=5)
    example.generate_cohort(str(tmp_path / "ref"), **kw)
    tdemo.generate_cohort(str(tmp_path / "port"), **kw)
    names = sorted(os.path.relpath(f, tmp_path / "ref") for f in glob.glob(
        str(tmp_path / "ref" / "**" / "*.*"), recursive=True))
    assert names == sorted(
        os.path.relpath(f, tmp_path / "port") for f in glob.glob(
            str(tmp_path / "port" / "**" / "*.*"), recursive=True))
    assert len(names) == 3 * (2 * 3 + 2)  # frames, gt, rvip, 4d, Info.cfg
    for name in names:
        a, b = str(tmp_path / "port" / name), str(tmp_path / "ref" / name)
        if name.endswith(".cfg"):
            assert open(a).read() == open(b).read()
        else:
            assert _same_file(a, b), name


def test_dice_numpy_matches_cmrtpu():
    from cmrtpu.train.losses import dice_numpy as jax_dice
    from cmrtpu_torch.train.losses import dice_numpy

    rng = np.random.default_rng(11)
    for density in (0.0, 0.1, 0.5):
        a = rng.random((3, 9, 7)) < density
        b = rng.random((3, 9, 7)) < 0.3
        for pair in ((a, b), (a, a), (a.astype(np.uint8) * 2, b)):
            assert dice_numpy(*pair) == jax_dice(*pair)
    assert dice_numpy(np.zeros(4), np.zeros(4), empty_score=0.5) == 0.5
    with pytest.raises(ValueError):
        dice_numpy(np.zeros(3), np.zeros(4))


def test_seg_slices_match_example(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "full_cv_demo_example", os.path.join(REPO, "examples",
                                             "full_cv_demo.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for name in ("ref", "port"):
        root = tmp_path / name
        tdemo.generate_cohort(str(root), n_patients=2, hw=48, n_slices=3,
                              seed=4)
        td.create_2d_slices_from_3d_volume_files(
            str(root / "original" / "patient001" /
                "patient001_frame01.nii.gz"),
            str(root / "io" / "patient001_frame01_rvip.nrrd"),
            str(root / "2D"))
        (example._write_seg_slices if name == "ref"
         else tdemo._write_seg_slices)(str(root))
    segs = sorted(os.path.basename(f) for f in glob.glob(
        str(tmp_path / "ref" / "2D" / "*_seg.nrrd")))
    assert len(segs) == 3
    assert segs == sorted(os.path.basename(f) for f in glob.glob(
        str(tmp_path / "port" / "2D" / "*_seg.nrrd")))
    for name in segs:
        assert _same_file(str(tmp_path / "port" / "2D" / name),
                          str(tmp_path / "ref" / "2D" / name)), name
