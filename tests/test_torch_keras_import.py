"""Import of the reference's keras weights-only ``model.h5``
(``cmrtpu_torch/train/keras_import.py`` and the h5 route of
``train/checkpoint.py``) against cmrtpu's importer.

The h5 fixtures are built by hand in the keras weights-only layout, with
the layer sequence the reference graph produces for both decoders; the
writers are copies of tests/test_keras_import.py's (so this file imports no
other test module). The port's imported trees equal cmrtpu's
``import_keras_unet_weights`` of the same file exactly (both only copy,
swap and flip arrays); the forward of the port's model with them lies
within the U-Net tolerance (1e-4, f32) of cmrtpu's ``model.apply``; a
config that does not match the file raises in both; a fold directory with
only ``model.h5`` restores through the port's ``Predictor`` and
``load_pretrained_model``; with h5py hidden, as on the card, the error
names the route through ``model.npz``, and the npz written on a host with
h5py loads in cmrtpu as its own import."""

import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict.predictor import Predictor as JaxPredictor
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu.train.keras_import import \
    import_keras_unet_weights as jax_import
from cmrtpu.train.keras_import import \
    read_keras_h5_weights as jax_read
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train.checkpoint import (STATE_NAME, flax_to_state_dict,
                                           load_pretrained_model,
                                           load_weights_for_model,
                                           save_train_state, save_weights)
from cmrtpu_torch.train.keras_import import (import_keras_unet_weights,
                                             read_keras_h5_weights)

torch.set_num_threads(1)

ATOL = 1e-4  # U-Net probabilities in f32 (tests/test_torch_unet.py)

CFG = {"DIM": [16, 16], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
       "IMG_CHANNELS": 1, "MIXED_PRECISION": False, "ACTIVATION": "relu",
       "BATCH_NORMALISATION": True, "BN_FIRST": False, "USE_UPSAMPLE": True,
       "F_SIZE": [3, 3], "M_POOL": [2, 2], "DROPOUT_MIN": 0.0,
       "DROPOUT_MAX": 0.0}
CFG_T = dict(CFG, USE_UPSAMPLE=False)

# the reference 2D U-Net graphs at DEPTH=2/FILTERS=4, as keras saves them:
# (layer_name, kind, shape-spec); weightless layers carry empty weight_names
KERAS_LAYERS = [
    ("input_1", None, None),
    # encoder block 0 (filters 4)
    ("conv2d", "conv", (3, 3, 1, 4)),
    ("batch_normalization", "bn", 4),
    ("dropout", None, None),
    ("conv2d_1", "conv", (3, 3, 4, 4)),
    ("batch_normalization_1", "bn", 4),
    ("max_pooling2d", None, None),
    # encoder block 1 (filters 8)
    ("conv2d_2", "conv", (3, 3, 4, 8)),
    ("batch_normalization_2", "bn", 8),
    ("dropout_1", None, None),
    ("conv2d_3", "conv", (3, 3, 8, 8)),
    ("batch_normalization_3", "bn", 8),
    ("max_pooling2d_1", None, None),
    # bottleneck (filters 16)
    ("conv2d_4", "conv", (3, 3, 8, 16)),
    ("batch_normalization_4", "bn", 16),
    ("dropout_2", None, None),
    ("conv2d_5", "conv", (3, 3, 16, 16)),
    ("batch_normalization_5", "bn", 16),
    # decoder block 0 (filters 8): upsample, conv, concat(8+8), conv bn conv bn
    ("up_sampling2d", None, None),
    ("conv2d_6", "conv", (3, 3, 16, 8)),
    ("concatenate", None, None),
    ("conv2d_7", "conv", (3, 3, 16, 8)),
    ("batch_normalization_6", "bn", 8),
    ("dropout_3", None, None),
    ("conv2d_8", "conv", (3, 3, 8, 8)),
    ("batch_normalization_7", "bn", 8),
    # decoder block 1 (filters 4)
    ("up_sampling2d_1", None, None),
    ("conv2d_9", "conv", (3, 3, 8, 4)),
    ("concatenate_1", None, None),
    ("conv2d_10", "conv", (3, 3, 8, 4)),
    ("batch_normalization_8", "bn", 4),
    ("dropout_4", None, None),
    ("conv2d_11", "conv", (3, 3, 4, 4)),
    ("batch_normalization_9", "bn", 4),
    # head, the only explicitly named layer (ref: Unets.py:128)
    ("unet", "conv", (1, 1, 4, 2)),
]

KERAS_LAYERS_T = (
    KERAS_LAYERS[:18]  # input through bottleneck bn_5 (identical)
    + [
        ("conv2d_transpose", "convT", (3, 3, 8, 16)),   # (kh,kw,out,in)
        ("concatenate", None, None),
        ("conv2d_6", "conv", (3, 3, 16, 8)),
        ("batch_normalization_6", "bn", 8),
        ("dropout_3", None, None),
        ("conv2d_7", "conv", (3, 3, 8, 8)),
        ("batch_normalization_7", "bn", 8),
        ("conv2d_transpose_1", "convT", (3, 3, 4, 8)),
        ("concatenate_1", None, None),
        ("conv2d_8", "conv", (3, 3, 8, 4)),
        ("batch_normalization_8", "bn", 4),
        ("dropout_4", None, None),
        ("conv2d_9", "conv", (3, 3, 4, 4)),
        ("batch_normalization_9", "bn", 4),
        ("unet", "conv", (1, 1, 4, 2)),
    ])


def _write_keras_h5(path, rng):
    """Hand-built keras weights-only h5; returns {layer_name: {leaf: arr}}."""
    stored = {}
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode()
                                           for n, _, _ in KERAS_LAYERS])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.3.0"
        for name, kind, spec in KERAS_LAYERS:
            g = f.create_group(name)
            if kind is None:
                g.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            if kind == "conv":
                arrs = {"kernel": rng.normal(0, 0.1, spec).astype(np.float32),
                        "bias": rng.normal(0, 0.02, spec[-1]).astype(np.float32)}
                names = ["kernel", "bias"]
            else:
                c = spec
                arrs = {"gamma": rng.uniform(0.6, 1.4, c).astype(np.float32),
                        "beta": rng.normal(0, 0.05, c).astype(np.float32),
                        "moving_mean": rng.normal(0, 0.1, c).astype(np.float32),
                        "moving_variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}
                names = ["gamma", "beta", "moving_mean", "moving_variance"]
            g.attrs["weight_names"] = np.array(
                [f"{name}/{w}:0".encode() for w in names])
            for w in names:
                g.create_dataset(f"{name}/{w}:0", data=arrs[w])
            stored[name] = arrs
    return stored


def _write_keras_h5_layers(path, rng, layers):
    stored = {}
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n, _, _ in layers])
        for name, kind, spec in layers:
            g = f.create_group(name)
            if kind is None:
                g.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            if kind in ("conv", "convT"):
                arrs = {"kernel": rng.normal(0, 0.1, spec).astype(np.float32),
                        "bias": rng.normal(0, 0.02, spec[-2 if kind == "convT"
                                                         else -1]
                                           ).astype(np.float32)}
                names = ["kernel", "bias"]
            else:
                c = spec
                arrs = {"gamma": rng.uniform(0.6, 1.4, c).astype(np.float32),
                        "beta": rng.normal(0, 0.05, c).astype(np.float32),
                        "moving_mean": rng.normal(0, 0.1, c).astype(np.float32),
                        "moving_variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}
                names = ["gamma", "beta", "moving_mean", "moving_variance"]
            g.attrs["weight_names"] = np.array(
                [f"{name}/{w}:0".encode() for w in names])
            for w in names:
                g.create_dataset(f"{name}/{w}:0", data=arrs[w])
            stored[name] = arrs
    return stored


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(params=["upsample", "transpose"])
def case(request, tmp_path):
    """(config, h5 path) of each decoder."""
    cfg, layers, seed = (CFG, KERAS_LAYERS, 3) if request.param == "upsample" \
        else (CFG_T, KERAS_LAYERS_T, 13)
    path = str(tmp_path / "model.h5")
    _write_keras_h5_layers(path, np.random.default_rng(seed), layers)
    return cfg, path


def _jax_variables(cfg, path):
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg,
                               jax.random.key(0, impl="threefry2x32"))
    return model, jax_import(variables, path, cfg)


def test_reader_matches(case):
    _, path = case
    got, want = read_keras_h5_weights(path), jax_read(path)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, gw), (_, ww) in zip(got, want):
        assert [w for w, _ in gw] == [w for w, _ in ww]
        for (_, a), (_, b) in zip(gw, ww):
            np.testing.assert_array_equal(a, b)


def test_fixture_writer_matches_the_other(tmp_path):
    """Both copied writers give the same file for the upsample graph."""
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    stored_a = _write_keras_h5(a, np.random.default_rng(3))
    stored_b = _write_keras_h5_layers(b, np.random.default_rng(3),
                                      KERAS_LAYERS)
    assert stored_a.keys() == stored_b.keys()
    for (_, wa), (_, wb) in zip(read_keras_h5_weights(a),
                                read_keras_h5_weights(b)):
        for (_, x), (_, y) in zip(wa, wb):
            np.testing.assert_array_equal(x, y)


def test_imported_trees_match_cmrtpu(case):
    cfg, path = case
    got = import_keras_unet_weights(build_model(cfg), path, cfg)
    _, want = _jax_variables(cfg, path)
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(want[coll])
        assert g.keys() == w.keys()
        for key in g:
            assert g[key].dtype == w[key].dtype == np.float32, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))


def test_forward_matches_cmrtpu(case):
    cfg, path = case
    model = load_weights_for_model(os.path.dirname(path), build_model(cfg),
                                   cfg).eval()
    jmodel, variables = _jax_variables(cfg, path)
    x = np.random.default_rng(5).normal(size=(3, 16, 16, 1)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(variables, x, train=False))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - 0.5).max() > 1e-3  # not a constant output


@pytest.mark.parametrize("change", [{"DEPTH": 3}, {"DEPTH": 1},
                                    {"BATCH_NORMALISATION": False},
                                    {"FILTERS": 8}, "decoder"])
def test_config_mismatch_raises(case, change):
    cfg, path = case
    if change == "decoder":
        change = {"USE_UPSAMPLE": not cfg["USE_UPSAMPLE"]}
    bad = dict(cfg, **change)
    with pytest.raises(ValueError, match="mismatch"):
        import_keras_unet_weights(build_model(bad), path, bad)
    model = jax_build_model(bad)
    variables = init_variables(model, bad,
                               jax.random.key(0, impl="threefry2x32"))
    with pytest.raises(ValueError, match="mismatch"):
        jax_import(variables, path, bad)


def test_predictor_restores_from_an_h5_only_fold(case, tmp_path):
    cfg, path = case
    model_dir = tmp_path / "fold" / "model"
    model_dir.mkdir(parents=True)
    shutil.copy(path, model_dir / "model.h5")
    x = np.random.default_rng(6).normal(size=(3, 16, 16, 1)).astype(
        np.float32)
    got = Predictor(dict(cfg, BATCHSIZE=2), model_path=str(model_dir),
                    device="cpu").predict(x)
    want = JaxPredictor(dict(cfg, BATCHSIZE=2),
                        model_path=str(model_dir)).predict(x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_npz_route_for_hosts_without_h5py(case, tmp_path, monkeypatch):
    """On a host with h5py the fold is imported and written as model.npz,
    which cmrtpu loads as its own import of the h5; with h5py hidden the
    h5 route raises and names that route, and the npz loads."""
    cfg, path = case
    model = load_weights_for_model(path, build_model(cfg), cfg)
    npz_dir = str(tmp_path / "npz")
    save_weights(npz_dir, model)
    params, stats = jax_ckpt.load_weights(npz_dir)
    _, want = _jax_variables(cfg, path)
    for got, ref in ((params, want["params"]), (stats, want["batch_stats"])):
        g, w = _flat(got), _flat(ref)
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="model.npz"):
        load_weights_for_model(os.path.dirname(path), build_model(cfg), cfg)
    restored = load_weights_for_model(npz_dir, build_model(cfg), cfg)
    for key, t in model.state_dict().items():
        assert torch.equal(t, restored.state_dict()[key]), key


def test_load_pretrained_model_chain(case, tmp_path):
    """state.pt, else model.npz, else model.h5: each added file takes
    over."""
    cfg, path = case
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    shutil.copy(path, os.path.join(model_dir, "model.h5"))
    from_h5, state = load_pretrained_model(model_dir, build_model(cfg), cfg)
    assert state is None
    imported = import_keras_unet_weights(build_model(cfg), path, cfg)
    want = flax_to_state_dict(imported["params"], imported["batch_stats"])
    for key, t in from_h5.state_dict().items():
        assert torch.equal(t, want[key]), key

    other = build_model(cfg)  # its own seeded init
    save_weights(model_dir, other)
    from_npz, state = load_pretrained_model(model_dir, build_model(cfg), cfg)
    assert state is None
    for key, t in from_npz.state_dict().items():
        assert torch.equal(t, other.state_dict()[key]), key

    live = {k: v + 1 if v.is_floating_point() else v
            for k, v in other.state_dict().items()}
    save_train_state(model_dir, {"model": live, "step": 7})
    assert os.path.exists(os.path.join(model_dir, STATE_NAME))
    from_state, state = load_pretrained_model(model_dir, build_model(cfg),
                                              cfg)
    assert state["step"] == 7
    for key, t in from_state.state_dict().items():
        assert torch.equal(t, live[key]), key
