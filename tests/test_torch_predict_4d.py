"""4D cine prediction (``predict_4d_on_2d_cv``, ``cli/predict_4d.py``),
``select_4d_landmark_head``, the stacked CC filter and
``predict_override_twin`` of cmrtpu_torch against cmrtpu's, on the CPU.

One ACDC-like data root (6 patients, ED/ES frames of 3 slices, RVIP masks,
a 3-frame cine each, sliced by the port's make_dataset CLI) and, per case,
one fold whose flax weights are drawn from a pinned key and saved by
cmrtpu (the heads' kernels scaled by 20, so few probabilities lie near
the 0.5 threshold). The cases: a single head with 2 and with 3 channels, a
HEADS model with a sigmoid head after a softmax one, HEADS with softmax
heads only (the argmax fallback), CC_FILTER false / true / '3d', and
RESAMPLE false.

* End to end, both packages predict the fold's cines: the files' names,
  headers (the nrrd text before the data) and shapes are equal, and their
  labels too, except at voxels where cmrtpu's probability (any channel of
  a sigmoid head) lies within 1e-4 of 0.5, or its two largest softmax
  probabilities within 1e-4 of each other; those voxels are at most 0.1%
  of all. On the CPU the port labels each cine in one call of the plain
  labelling (the 2D or the 3D one), where cmrtpu filters each t apart.
* Stage by stage, both packages' ``Predictor.predict`` return the same
  probabilities (drawn from the crc of the batch, which the two identical
  preprocessings give bit for bit): the written files are byte-equal.
* The stacked filter equals the per-t loop exactly, for the 2D and the 3D
  filter, and cmrtpu's filter of each t.
* ``select_4d_landmark_head`` returns cmrtpu's triple and warns as it
  does; ``predict_override_twin`` rejects the same keys and writes the
  same twin config, apart from the root."""

import glob
import json
import logging
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.hybrids import get_model as jax_get_model
from cmrtpu.models.unet import init_variables
from cmrtpu.ops import connected_components as jcc
from cmrtpu.predict import predictor as JP
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.cli import make_dataset as cli_md
from cmrtpu_torch.cli import predict_4d as cli_p4d
from cmrtpu_torch.data.dataset import fold_patients
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.ops import connected_components as tcc
from cmrtpu_torch.predict import predictor as TP

torch.set_num_threads(1)

SHAPE = (3, 36, 34)  # z, y, x of a frame
T = 3
SPACING = (1.4, 1.4, 8.0)
CINE_SPACING = (1.3, 1.45, 8.0, 1.0)
NEAR, NEAR_SHARE = 1e-4, 1e-3

BASE = {"EXPERIMENT": "p4d", "DIM": [32, 32], "SPACING": [1.4, 1.4],
        "DEPTH": 2, "FILTERS": 4, "GROUP_NORM": 4, "MASK_VALUES": [1, 2],
        "MASK_CLASSES": 2, "BATCHSIZE": 4, "RESAMPLE": True,
        "MIXED_PRECISION": False, "CC_FILTER": True, "GAUS": True,
        "SIGMA": 1, "AUGMENT": False, "FOLDS": [0]}
CASES = {
    "single2": {},
    "single3": {"MASK_VALUES": [1, 2, 3], "MASK_CLASSES": 3},
    "heads_sigmoid": {"HEADS": [["seg", 4, "softmax"],
                                ["rvip", 2, "sigmoid"]]},
    "all_softmax": {"HEADS": [["seg", 4, "softmax"],
                              ["ven", 3, "softmax"]]},
    "cc_off": {"CC_FILTER": False},
    "cc_3d": {"CC_FILTER": "3d"},
    "no_resample": {"RESAMPLE": False},
}


def _write_tree(root):
    """Info.cfg, ED/ES frames with ventricle masks, RVIP masks under io/
    and a 3-frame cine per patient."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
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
            ring = np.hypot(yy - 18, xx - 22)
            gt = np.zeros(SHAPE, np.uint8)
            gt[:, ring < 7] = 2
            gt[:, ring < 3] = 3
            write_image(MedicalImage(array=gt, spacing=SPACING),
                        os.path.join(p, f"{stem}_gt.nii.gz"))
            write_image(MedicalImage(array=rvip, spacing=SPACING),
                        os.path.join(root, "io", f"{stem}_rvip.nrrd"))
            frames.append(vol)
        cine = np.stack([frames[0], (frames[0] + frames[1]) / 2, frames[1]])
        write_image(MedicalImage(array=cine.astype(np.float32),
                                 spacing=CINE_SPACING,
                                 origin=(2.0, -3.0, 5.0, 0.0)),
                    os.path.join(p, f"{pid}_4d.nii.gz"))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data4d"))
    os.makedirs(os.path.join(root, "io"))
    _write_tree(root)
    cli_md.cli(["-data_root", root, "-acdc_data",
                os.path.join(root, "original")])
    return root


def _heads(cfg):
    return [tuple(h) for h in cfg.get("HEADS", ())]


@pytest.fixture(scope="module")
def folds(data_root, tmp_path_factory):
    """case -> (experiment root, fold config), made once per case: the
    fold's config.json and a model.npz of cmrtpu's seeded init."""
    base = tmp_path_factory.mktemp("exp4d")
    made = {}

    def make(case):
        if case in made:
            return made[case]
        exp = str(base / case)
        fold = os.path.join(exp, "f0")
        cfg = dict(BASE, **CASES[case], EXP_PATH=fold, FOLD=0,
                   MODEL_PATH=os.path.join(fold, "model"),
                   DATA_PATH_SAX=os.path.join(data_root, "2D"),
                   DF_FOLDS=os.path.join(data_root, "df_kfold.csv"),
                   DATA_PATH_ORIG=os.path.join(data_root, "original"))
        os.makedirs(os.path.join(fold, "config"))
        with open(os.path.join(fold, "config", "config.json"), "w") as fh:
            json.dump(cfg, fh)
        model = jax_get_model(cfg)
        variables = init_variables(model, cfg, jax.random.key(
            list(CASES).index(case), impl="threefry2x32"))
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        params = {k: ({**v, "kernel": v["kernel"] * 20}
                      if k.startswith("head") else v)
                  for k, v in dict(params).items()}
        stats = jax.tree_util.tree_map(np.asarray,
                                       variables.get("batch_stats", {}))
        jax_ckpt.save_weights(cfg["MODEL_PATH"], params, stats)
        made[case] = exp, cfg
        return made[case]

    return make


def _cines(data_root, cfg):
    test = fold_patients(cfg["DF_FOLDS"], 0)
    files = sorted(glob.glob(os.path.join(data_root, "original", "*",
                                          "*4d.nii.gz")))
    return [f for f in files if any(p in f for p in test)]


def _near(cfg, f4d):
    """[t, z, H, W] voxels whose cmrtpu label is within NEAR of flipping:
    a sigmoid probability near 0.5, or the two largest softmax
    probabilities near each other."""
    name, act, _ = JP.select_4d_landmark_head(cfg)
    vol = read_image(f4d)
    nda = vol.array
    batch = JP.preprocess_model_input(
        nda.reshape(-1, *nda.shape[2:]), vol.spacing[:2], cfg)
    probs = JP.Predictor(cfg).predict(batch)
    if isinstance(probs, dict):
        probs = probs[name] if name in probs else next(iter(probs.values()))
    if act == "softmax":
        top = np.sort(probs, axis=-1)
        near = top[..., -1] - top[..., -2] <= NEAR
    else:
        near = (np.abs(probs - 0.5) <= NEAR).any(axis=-1)
    return near.reshape(nda.shape[0], nda.shape[1], *probs.shape[1:3])


def _nrrd_header(path):
    with open(path, "rb") as fh:
        return fh.read().split(b"\n\n", 1)[0]


class _Calls:
    """Counts calls of a module function (patched by monkeypatch)."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        real = getattr(module, name)

        def counted(*args, **kw):
            self.n += 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("case", list(CASES))
def test_predict_4d_matches_cmrtpu(folds, data_root, case, monkeypatch):
    exp, cfg = folds(case)
    JP.predict_4d_on_2d_cv(exp, data_root, export_suffix="jax")
    labels_2d = _Calls(monkeypatch, tcc, "_converge_batch")
    labels_3d = _Calls(monkeypatch, tcc, "_converge_volumes")
    TP.predict_4d_on_2d_cv(exp, data_root, export_suffix="torch",
                           device="cpu")
    cines = _cines(data_root, cfg)
    assert len(cines) == 2
    # one labelling per cine, of the filter the config selects (the 2D
    # one when CC_FILTER is off: the 4D flow always filters)
    three_d = cfg["CC_FILTER"] == "3d"
    assert (labels_2d.n, labels_3d.n) == ((0, 2) if three_d else (2, 0))
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(exp, "f0", "torch", "*")))
    assert names == sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(exp, "f0", "jax", "*")))
    assert names == [os.path.basename(f).replace(".nii.gz", "_pred.nrrd")
                     for f in cines]
    near_total = voxels = labelled = 0
    for f4d, name in zip(cines, names):
        got_f = os.path.join(exp, "f0", "torch", name)
        want_f = os.path.join(exp, "f0", "jax", name)
        assert _nrrd_header(got_f) == _nrrd_header(want_f)
        got, want = read_image(got_f), read_image(want_f)
        assert got.array.dtype == want.array.dtype == np.uint8
        assert got.array.shape == want.array.shape == (T, SHAPE[0], 32, 32)
        sx, sy = (1.4, 1.4) if cfg["RESAMPLE"] else CINE_SPACING[:2]
        np.testing.assert_allclose(got.spacing, (sx, sy, 8.0, 1.0),
                                   rtol=1e-6)
        near = _near(cfg, f4d)
        assert not ((got.array != want.array) & ~near).any(), name
        near_total += int(near.sum())
        voxels += near.size
        labelled += int((want.array > 0).sum())
    assert near_total <= NEAR_SHARE * voxels
    assert labelled > 0


def _fake_predict(cfg):
    """A stand-in for both packages' ``Predictor.predict``: probabilities
    drawn from the crc of the batch, per head for a HEADS model; tensors
    with ``to_host`` False, as the port's returns."""
    heads = _heads(cfg) or [("msk", cfg["MASK_CLASSES"], "sigmoid")]

    def predict(self, x, to_host=True):
        rng = np.random.default_rng(zlib.crc32(np.ascontiguousarray(
            x).tobytes()))
        out = {}
        for name, channels, act in heads:
            p = rng.random((x.shape[0], *x.shape[1:3], int(channels)),
                           dtype=np.float32)
            if act == "softmax":
                p = p / p.sum(axis=-1, keepdims=True)
            else:
                p = p ** 2  # a quarter of the voxels over 0.5
            out[name] = p if to_host else torch.from_numpy(p)
        return out if _heads(cfg) else out["msk"]
    return predict


@pytest.mark.parametrize("case", list(CASES))
def test_predict_4d_stages_write_the_same_bytes(folds, data_root, case,
                                                monkeypatch):
    exp, cfg = folds(case)
    monkeypatch.setattr(JP.Predictor, "predict", _fake_predict(cfg))
    monkeypatch.setattr(TP.Predictor, "predict", _fake_predict(cfg))
    JP.predict_4d_on_2d_cv(exp, data_root, export_suffix="stage_jax")
    TP.predict_4d_on_2d_cv(exp, data_root, export_suffix="stage_torch",
                           device="cpu")
    got = sorted(glob.glob(os.path.join(exp, "f0", "stage_torch", "*")))
    want = sorted(glob.glob(os.path.join(exp, "f0", "stage_jax", "*")))
    assert [os.path.basename(f) for f in got] == \
        [os.path.basename(f) for f in want] and len(got) == 2
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read(), g
    labels = read_image(got[0]).array
    assert labels.any() and (labels == 0).any()


def test_cli_writes_what_the_function_writes(folds, data_root):
    exp, _ = folds("single2")
    TP.predict_4d_on_2d_cv(exp, data_root, export_suffix="fn", device="cpu")
    cli_p4d.main(["-exp", exp, "-data", data_root, "-suffix", "cli",
                  "--device", "cpu"])
    fn = sorted(glob.glob(os.path.join(exp, "f0", "fn", "*")))
    cli = sorted(glob.glob(os.path.join(exp, "f0", "cli", "*")))
    assert len(fn) == len(cli) == 2
    for a, b in zip(fn, cli):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_predict_4d_device_default_is_cuda(folds, data_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    exp, _ = folds("single2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.predict_4d_on_2d_cv(exp, data_root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_p4d.main(["-exp", exp, "-data", data_root])


def test_predict_4d_logs_stage_spans(folds, data_root, caplog):
    exp, _ = folds("single2")
    caplog.set_level(logging.DEBUG, logger=TP.TIMING_LOG.name)
    TP.predict_4d_on_2d_cv(exp, data_root, export_suffix="spans",
                           device="cpu")
    spans = [r.timing for r in caplog.records if hasattr(r, "timing")]
    assert [s["event"] for s in spans] == ["4d_start", "4d_file", "4d_file",
                                           "4d_end"]
    for span in spans[1:3]:
        assert span["slices"] == T * SHAPE[0]
        stages = [span[k] for k in ("read_s", "preprocess_s", "forward_s",
                                    "cc_s", "write_s")]
        assert min(stages) >= 0
        assert sum(stages) == pytest.approx(span["total_s"])
    assert spans[-1]["wall_s"] >= sum(s["total_s"] for s in spans[1:3])


def _labels(rng, shape, values, density):
    flat = np.zeros(shape, np.uint8)
    for v in values:
        flat[rng.random(shape) < density] = v
    return flat


@pytest.mark.parametrize("mode", ["2d", "3d"])
@pytest.mark.parametrize("values,density", [((1, 2), 0.3), ((1, 2, 3), 0.2),
                                            ((2,), 0.05), ((1, 2), 0.0)])
def test_stacked_cc_equals_the_per_t_loop(mode, values, density,
                                          monkeypatch):
    rng = np.random.default_rng(len(values) * 10 + int(density * 10))
    flat = _labels(rng, (4, 3, 20, 18), values, density)
    clean = tcc.clean_prediction_2d_cc if mode == "2d" \
        else tcc.clean_prediction_3d_cc
    ref = jcc.clean_prediction_2d_cc if mode == "2d" \
        else jcc.clean_prediction_3d_cc
    calls = _Calls(monkeypatch, tcc, "_converge_batch" if mode == "2d"
                   else "_converge_volumes")
    got = clean(flat, values).numpy()
    assert calls.n == 1
    loop = np.stack([clean(flat[t], values).numpy() for t in range(4)])
    np.testing.assert_array_equal(got, loop)
    np.testing.assert_array_equal(got, np.stack([
        np.asarray(ref(flat[t], values)) for t in range(4)]))
    if density:
        assert (got != flat).any()  # the filter removed something


@pytest.mark.parametrize("heads", [None, [], [["rvip", 2, "sigmoid"]],
                                   [["seg", 4, "softmax"],
                                    ["rvip", 3, "sigmoid"],
                                    ["lm", 2, "sigmoid"]],
                                   [["seg", 4, "softmax"],
                                    ["ven", 3, "softmax"]]])
def test_select_4d_landmark_head_matches(heads, caplog):
    cfg = {} if heads is None else {"HEADS": heads}
    got = TP.select_4d_landmark_head(cfg)
    port_log = caplog.text
    caplog.clear()
    assert got == JP.select_4d_landmark_head(cfg)
    assert ("no sigmoid landmark head" in port_log) == \
        ("no sigmoid landmark head" in caplog.text)


@pytest.mark.parametrize("bad", [{"cc_filter": "3d"}, {"NOT_A_KEY": 1},
                                 {1: 2}, {"CC_FILTER": "3d", "Tta": True}])
def test_override_twin_rejects_bad_keys(folds, bad):
    exp, _ = folds("single2")
    for fn in (JP.predict_override_twin, TP.predict_override_twin):
        with pytest.raises(ValueError, match="unknown override key"):
            fn(exp, bad, "bad")
    assert not os.path.exists(exp + "_bad")


def test_override_twin_without_folds_raises(tmp_path):
    for fn in (JP.predict_override_twin, TP.predict_override_twin):
        with pytest.raises(FileNotFoundError, match="no fold dirs"):
            fn(str(tmp_path), {"CC_FILTER": "3d"}, "x")


def test_override_twin_matches_cmrtpu(folds):
    exp, _ = folds("single2")
    overrides = {"CC_FILTER": "3d", "HIST_MATCHING": False}
    j_root = JP.predict_override_twin(exp, overrides, "jax")
    t_root = TP.predict_override_twin(exp, overrides, "torch", device="cpu")
    assert (j_root, t_root) == (exp + "_jax", exp + "_torch")
    with open(os.path.join(j_root, "f0", "config", "config.json")) as fh:
        want = fh.read().replace(j_root, "<root>")
    with open(os.path.join(t_root, "f0", "config", "config.json")) as fh:
        got = fh.read().replace(t_root, "<root>")
    assert got == want
    cfg = json.loads(got)
    assert cfg["CC_FILTER"] == "3d" and cfg["EXP_PATH"] == "<root>/f0"
    assert cfg["MODEL_PATH"] == os.path.join(exp, "f0", "model")
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(t_root, "f0", "pred", "*.nrrd")))
    assert names == sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(j_root, "f0", "pred", "*.nrrd")))
    assert len(names) == 2 * 2 * 2  # patients x ED/ES x (msk, cmr)
