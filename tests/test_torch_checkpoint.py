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
