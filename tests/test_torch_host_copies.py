"""The port's own copies of cmrtpu's numpy-only host modules stay equal to
their sources: one case per copied module, on the same seeded inputs.

Configs compare as equal dicts, files written with the native codec byte
for byte (and each package reads the other's files), arrays exactly (the
copies run the same numpy code), with the native codec and with its
pure-Python path."""

import json
import os

import numpy as np
import pytest

import cmrtpu.config as jc
import cmrtpu.io as jio
import cmrtpu.native.cmrio as jcmrio
import cmrtpu.ops.resample as jr
import cmrtpu.pipeline.transforms as jt
import cmrtpu.predict.postprocess as jpp
import cmrtpu.utils.io_utils as jutil
import cmrtpu.utils.tfevents as jtf
import cmrtpu_torch.config as tc
import cmrtpu_torch.io as tio
import cmrtpu_torch.native.cmrio as tcmrio
import cmrtpu_torch.ops.resample as tr
import cmrtpu_torch.pipeline.transforms as tt
import cmrtpu_torch.predict.postprocess as tpp
import cmrtpu_torch.utils.io_utils as tutil
import cmrtpu_torch.utils.tfevents as ttf

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "exp", "template_cfgs",
    "gaus_sigma2_config.json")


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
