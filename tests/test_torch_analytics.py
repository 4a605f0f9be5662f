"""``cmrtpu_torch/data/analytics.py`` against ``cmrtpu/data/analytics.py``.

The same files (written once) and the same rows go through both packages.
Each port table (a list of row dicts) must equal cmrtpu's
``DataFrame.to_dict("records")``: the same columns in the same order and
equal values, NaN equal to NaN, arrays exactly; a dict (describe_volume)
must equal cmrtpu's; volume curves exactly. No tolerance: both sides run
the same numpy code."""

import numpy as np
import pandas as pd
import pytest

from cmrtpu.data import analytics as JA
from cmrtpu.io import MedicalImage as JaxImage
from cmrtpu_torch.data import analytics as TA
from cmrtpu_torch.io import MedicalImage, write_image

PHASES = ["ED#", "MS#", "ES#", "PF#", "MD#"]


def _norm(v):
    if isinstance(v, float) and np.isnan(v):
        return "<nan>"
    if isinstance(v, np.ndarray):
        return ("<array>", v.dtype.str, v.shape, v.tobytes())
    return v


def _same_rows(got, want):
    assert [[(k, _norm(v)) for k, v in r.items()] for r in got] == \
        [[(k, _norm(v)) for k, v in r.items()] for r in want]


def _cine(ed, es, t=10, z=3, hw=12, spacing=(1.0, 1.2, 5.0, 1.0)):
    """A 4D label volume whose LV (label 3) is biggest at ed, smallest at
    es, with an RV (label 1) that does not follow it."""
    nda = np.zeros((t, z, hw, hw), np.uint8)
    for ti in range(t):
        r = 5 if ti == ed else (1 if ti == es else 3)
        c = hw // 2
        nda[ti, :, c - r // 2:c + r // 2 + 1, c - r // 2:c + r // 2 + 1] = 3
        nda[ti, 0, 0:(ti % 4) + 1, 0] = 1
    return nda, spacing


@pytest.fixture(scope="module")
def cines(tmp_path_factory):
    root = tmp_path_factory.mktemp("cines")
    paths = []
    for pid, (ed, es, t) in {"patient001": (2, 7, 10),
                             "patient002": (0, 5, 8),
                             "patient013": (9, 3, 12)}.items():
        nda, spacing = _cine(ed, es, t)
        path = str(root / f"{pid}_4d_gt.nrrd")
        write_image(MedicalImage(array=nda, spacing=spacing), path)
        paths.append(path)
    tof = []
    for pid in ("TOF-A12", "TOF-b07"):
        nda, spacing = _cine(1, 4, 6)
        path = str(root / f"{pid}_4d.nrrd")
        write_image(MedicalImage(array=nda, spacing=spacing), path)
        tof.append(path)
    return paths, tof


@pytest.mark.parametrize("case", ["4d", "3d", "2d", "file", "metadata"])
def test_describe_volume_matches(cines, tmp_path, case):
    rng = np.random.default_rng(4)
    if case == "file":
        arg = jarg = cines[0][0]
    else:
        shape = {"4d": (3, 2, 6, 5), "3d": (2, 6, 5), "2d": (6, 5),
                 "metadata": (2, 6, 5)}[case]
        spacing = (1.1, 1.3, 7.0, 1.0)[:len(shape)]
        arr = rng.normal(size=shape).astype(np.float32)
        meta = {"0018|0050": "7.0", "0020|000e": "1.2.3", "other": "x"} \
            if case == "metadata" else {}
        arg = MedicalImage(array=arr, spacing=spacing, metadata=meta)
        jarg = JaxImage(array=arr, spacing=spacing, metadata=meta)
    for image in (True, False):
        got = TA.describe_volume(arg, image=image)
        want = JA.describe_volume(jarg, image=image)
        assert list(got) == list(want)
        assert got == want


@pytest.mark.parametrize("label", [1, 3])
def test_calc_vol_along_t_matches(cines, label):
    for path in cines[0]:
        got = TA.calc_vol_along_t(path, label)
        want = JA.calc_vol_along_t(path, label)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset", ["acdc", "tof"])
def test_create_lv_vol_df_matches(cines, dataset):
    files = cines[0] if dataset == "acdc" else cines[1]
    _same_rows(TA.create_lv_vol_df(files, dataset),
               JA.create_lv_vol_df(files, dataset).to_dict("records"))


def _phase_csv(path, patients, extra=False):
    rng = np.random.default_rng(9)
    cols = {"patient": patients,
            **{c: rng.integers(1, 10, len(patients)) for c in PHASES}}
    if extra:
        cols["note"] = ["a", "", "c", "d"][:len(patients)]
        cols["weight"] = [70.5, np.nan, 80.0, 65.0][:len(patients)]
    pd.DataFrame(cols).to_csv(path, index=False)
    return path


@pytest.mark.parametrize("gt", ["none", "acdc", "duplicate", "es_only"])
def test_predict_phase_from_vol_matches(cines, tmp_path, gt):
    files = cines[0]
    if gt == "none":
        _same_rows(TA.predict_phase_from_vol(files),
                   JA.predict_phase_from_vol(files).to_dict("records"))
        return
    path = _phase_csv(str(tmp_path / "gt.csv"),
                      [1, 2, 13, 2] if gt == "duplicate" else [1, 2, 13, 44],
                      extra=True)
    rows = TA.load_acdc_phase_gt(path)
    df = JA.load_acdc_phase_gt(path)
    if gt == "es_only":
        rows = [{k: v for k, v in r.items() if k != "ED#"} for r in rows]
        df = df.drop(columns=["ED#"])
    got = TA.predict_phase_from_vol(files, gt_df=rows)
    want = JA.predict_phase_from_vol(files, gt_df=df)
    _same_rows(got, want.to_dict("records"))
    assert ("pfd_es" in got[0]) and (("pfd_ed" in got[0]) == (gt != "es_only"))


def test_predict_phase_suffixes_shared_columns(cines):
    """A gt column the curve table also has comes back as _x and _y in
    both packages, so neither finds a plain cycle_len to compute pfd."""
    rows = [{"patient": "1", "ED#": 2, "ES#": 7, "cycle_len": 99},
            {"patient": "2", "ED#": 1, "ES#": 5, "cycle_len": 98}]
    with pytest.raises(KeyError):
        JA.predict_phase_from_vol(cines[0], gt_df=pd.DataFrame(rows))
    with pytest.raises(KeyError):
        TA.predict_phase_from_vol(cines[0], gt_df=rows)


@pytest.mark.parametrize("values", [[50, 80, 60], [90, 40, 40, 90],
                                    [3.5, np.nan, 1.0]])
def test_extremas_match(values):
    rows = [{"patient": p, "vol in ml": v, "t_norm": t / 10}
            for p in ("p1", "p2") for t, v in enumerate(
                values if p == "p1" else values[::-1])]
    _same_rows(TA.get_extremas(rows),
               JA.get_extremas(pd.DataFrame(rows)).to_dict("records"))
    p1 = [r for r in rows if r["patient"] == "p1"]
    assert TA.get_min_max_t_per_patient(p1) == \
        JA.get_min_max_t_per_patient(pd.DataFrame(p1))


@pytest.mark.parametrize("case", ["ACDC", "wildcard", "GCN"])
def test_describe_path_matches(tmp_path, case):
    rng = np.random.default_rng(5)
    p = tmp_path / "patient001"
    p.mkdir()
    for name in ("patient001_frame01", "patient001_frame12"):
        arr = rng.normal(size=(2, 6, 5)).astype(np.float32)
        write_image(MedicalImage(array=arr, spacing=(1.3, 1.2, 8.0)),
                    str(p / f"{name}.nii.gz"))
        write_image(MedicalImage(array=(arr > 0).astype(np.uint8),
                                 spacing=(1.3, 1.2, 8.0)),
                    str(p / f"{name}_gt.nii.gz"))
    write_image(MedicalImage(array=np.ones((6, 5), np.float32),
                             spacing=(1.0, 1.0),
                             metadata={"0018|0050": "8.0"}),
                str(tmp_path / "a_img.nrrd"))
    write_image(MedicalImage(array=np.ones((6, 5), np.uint8)),
                str(tmp_path / "a_msk.nrrd"))
    kw = {"ACDC": {}, "wildcard": {"wildcard": "**/*frame01*.nii.gz"},
          "GCN": {"dataset": "GCN"}}[case]
    got = TA.describe_path(str(tmp_path), **kw)
    _same_rows(got, JA.describe_path(str(tmp_path), **kw).to_dict("records"))
    assert len(got) == {"ACDC": 4, "wildcard": 2, "GCN": 2}[case]


def test_phase_gt_loaders_match(tmp_path):
    path = _phase_csv(str(tmp_path / "tof.csv"), ["P1", "P1", "p2", "Q3"],
                      extra=True)
    _same_rows(TA.load_tof_phase_gt(path),
               JA.load_tof_phase_gt(path).to_dict("records"))
    for patients in ([7, 42, 100], ["7", "x9", "100"]):
        path = _phase_csv(str(tmp_path / "acdc.csv"), patients, extra=True)
        _same_rows(TA.load_acdc_phase_gt(path),
                   JA.load_acdc_phase_gt(path).to_dict("records"))
