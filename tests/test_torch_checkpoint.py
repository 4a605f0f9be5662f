"""model.npz interchange between cmrtpu and cmrtpu_torch.

A checkpoint written by either package loads into the other and is written
back with identical keys, shapes, dtypes and values — for GroupNorm and
BatchNorm U-Nets."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           load_weights_for_model,
                                           save_weights)

torch.set_num_threads(1)

CONFIGS = {
    "gn": {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "GROUP_NORM": 4,
           "MIXED_PRECISION": False},
    "bn": {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4,
           "BATCH_NORMALISATION": True, "MIXED_PRECISION": False},
}


def _npz(path):
    with np.load(os.path.join(path, "model.npz")) as blobs:
        return {k: blobs[k] for k in blobs.files}


def _assert_same_npz(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape, key
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _random_stats(model, seed):
    """Move norm parameters and running stats off their init values."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dtype.is_floating_point and t.dim() == 1:
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return model


@pytest.mark.parametrize("norm", sorted(CONFIGS))
def test_cmrtpu_npz_round_trips_through_port(norm, tmp_path):
    cfg = CONFIGS[norm]
    variables = init_variables(jax_build_model(cfg), cfg,
                               jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(
            np.float32), dict(variables))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_ckpt.save_weights(a, variables["params"],
                          variables.get("batch_stats"))
    model = load_weights_for_model(a, build_model(cfg), cfg)
    save_weights(b, model)
    _assert_same_npz(_npz(a), _npz(b))


@pytest.mark.parametrize("norm", sorted(CONFIGS))
def test_port_npz_loads_into_cmrtpu(norm, tmp_path):
    cfg = CONFIGS[norm]
    model = _random_stats(
        build_model(cfg).reset_parameters(torch.Generator().manual_seed(5)),
        seed=5)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_weights(a, model)
    params, stats = jax_ckpt.load_weights(a)

    # the tree the flax model expects: same paths, shapes and dtypes
    ref = init_variables(jax_build_model(cfg), cfg, jax.random.PRNGKey(0))
    shapes = lambda t: jax.tree_util.tree_map(
        lambda x: (np.shape(x), np.asarray(x).dtype), t)
    assert shapes(params) == shapes(ref["params"])
    assert shapes(stats) == shapes(dict(ref).get("batch_stats", {}))

    # the flax forward on the loaded tree is the port's forward
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jax_build_model(cfg).apply(
        {"params": params, "batch_stats": stats}, x, train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    # and cmrtpu writes it back unchanged
    jax_ckpt.save_weights(b, params, stats)
    _assert_same_npz(_npz(a), _npz(b))
    for key, t in flax_to_state_dict(params, stats).items():
        assert torch.equal(t, model.state_dict()[key]), key


def test_keras_h5_is_not_ported(tmp_path, monkeypatch):
    """A model directory with a keras model.h5 and no model.npz takes the
    keras route (train/keras_import.py, held to cmrtpu's importer in
    test_torch_keras_import.py). On a host without h5py, as the card, its
    error names the route through model.npz."""
    (tmp_path / "model.h5").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="save_weights"):
        load_weights_for_model(str(tmp_path), build_model(CONFIGS["gn"]),
                               CONFIGS["gn"])


def test_foreign_leaf_is_rejected():
    with pytest.raises(ValueError, match="not a leaf"):
        flax_to_state_dict({"ConvBlock_0": {"Conv_0": {
            "kernel_q": np.zeros((3, 3, 1, 4), np.int8)}}})


def _int8_twin_trees(cfg, seed):
    """cmrtpu's int8 twin of a seeded float model: calibrated on one
    random batch and quantized by cmrtpu's own quantize_variables."""
    from cmrtpu.predict.quantize import calibrate, quantize_variables

    model = jax_build_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(init_variables(
        model, cfg, jax.random.key(seed, impl="threefry2x32"))))
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 1)).astype(np.float32)
    qvars = quantize_variables(model, variables,
                               calibrate(model, variables, [x]))
    return jax.tree_util.tree_map(np.asarray, qvars), x


@pytest.mark.parametrize("norm", sorted(CONFIGS))
def test_int8_twin_npz_round_trips_cmrtpu_port_cmrtpu(norm, tmp_path):
    """An int8 twin's model.npz (int8 kernel_q, float32 w_scale, act_scale,
    bias) written by cmrtpu loads into the port's twin, is written back by
    the port, and cmrtpu reads that file back to the same arrays and
    dtypes, byte for byte."""
    cfg = dict(CONFIGS[norm], QUANT_INT8=True)
    qvars, _ = _int8_twin_trees(CONFIGS[norm], 7)
    a, b, c = (str(tmp_path / n) for n in "abc")
    jax_ckpt.save_weights(a, qvars["params"], qvars.get("batch_stats"))
    model = load_weights_for_model(a, build_model(cfg), cfg)
    assert model.DownBlock_0.ConvBlock_0.QuantConv_0.kernel_q.dtype \
        == torch.int8
    save_weights(b, model)
    _assert_same_npz(_npz(a), _npz(b))
    params, stats = jax_ckpt.load_weights(b)
    jax_ckpt.save_weights(c, params, stats)
    _assert_same_npz(_npz(a), _npz(c))
    for key, arr in _npz(a).items():
        assert arr.tobytes() == _npz(c)[key].tobytes(), key


def test_scalar_act_scale_loads_as_cmrtpu_loads_it(tmp_path):
    """A twin written before cmrtpu's round 4 stored a scalar act_scale;
    the port's load_weights broadcasts it to the per-input-channel vector
    of its kernel_q exactly as cmrtpu's does."""
    from cmrtpu_torch.train.checkpoint import load_weights

    qvars, _ = _int8_twin_trees(CONFIGS["gn"], 8)
    from flax import traverse_util
    flat = traverse_util.flatten_dict(qvars["params"])
    legacy = {k: (np.float32(v.max()) if k[-1] == "act_scale" else v)
              for k, v in flat.items()}
    jax_ckpt.save_weights(str(tmp_path), traverse_util.unflatten_dict(legacy),
                          qvars.get("batch_stats"))
    want = traverse_util.flatten_dict(jax_ckpt.load_weights(
        str(tmp_path))[0])
    got = traverse_util.flatten_dict(load_weights(str(tmp_path))[0])
    assert sorted(want) == sorted(got)
    scales = [k for k in want if k[-1] == "act_scale"]
    assert scales
    for k in want:
        assert np.asarray(want[k]).dtype == got[k].dtype, k
        np.testing.assert_array_equal(np.asarray(want[k]), got[k])
    for k in scales:
        assert got[k].shape == (flat[k[:-1] + ("kernel_q",)].shape[-2],)
    cfg = dict(CONFIGS["gn"], QUANT_INT8=True)
    load_weights_for_model(str(tmp_path), build_model(cfg), cfg)


@pytest.mark.parametrize("leaf", ["kernel_q_float", "kernel_q_rank3",
                                  "scale_in_qconv", "w_scale_2d"])
def test_unknown_int8_leaf_is_rejected(leaf):
    """The bridge still raises for any leaf it does not know, inside a
    QuantConv_0 too."""
    bad = {"kernel_q_float": ("kernel_q", np.zeros((3, 3, 1, 4), np.float32)),
           "kernel_q_rank3": ("kernel_q", np.zeros((3, 1, 4), np.int8)),
           "scale_in_qconv": ("scale", np.ones(4, np.float32)),
           "w_scale_2d": ("w_scale", np.ones((1, 4), np.float32))}[leaf]
    with pytest.raises(ValueError, match="not a leaf"):
        flax_to_state_dict({"ConvBlock_0": {"QuantConv_0": dict([bad])}})
