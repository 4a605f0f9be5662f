"""cmrtpu_torch's transpose-conv decoder (``USE_UPSAMPLE: false``) against
cmrtpu's ``nn.ConvTranspose(strides, padding='SAME')`` on bridged weights.

flax does not flip the transposed kernel and torch's transposed
convolution does; the bridge flips it and the port keeps lax's 'SAME'
window explicitly. Tolerances: the forward within 1e-4 in f32 and 2e-2
under MIXED_PRECISION; with ELU, every parameter's gradient of a fixed
weighted sum of the outputs within 1e-4 x its max |value| (with ReLU, f32
gradients at a random init are not comparable at that bound, PERF.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           state_dict_to_flax)
from test_torch_unet import forward_both, perturbed_variables

torch.set_num_threads(1)

BASE = {"DIM": [32, 32], "DEPTH": 3, "FILTERS": 8, "MASK_CLASSES": 2,
        "MIXED_PRECISION": False, "USE_UPSAMPLE": False}


@pytest.mark.parametrize("extra", [
    {"GROUP_NORM": 4},
    {"BATCH_NORMALISATION": True, "DIM": [32, 48]},
    {"GROUP_NORM": 4, "DIM": [8, 64], "DEPTH": 4},  # a pool clamped to 1
    {"GROUP_NORM": 4, "F_SIZE": [5, 5], "DEPTH": 2},
    {"BATCH_NORMALISATION": True, "HEADS": [["rvip", 2, "sigmoid"],
                                            ["seg", 4, "softmax"]]},
], ids=["gn", "bn-oblong", "clamped-pool", "kernel-5", "heads"])
def test_transpose_forward_matches_flax_f32(extra):
    cfg = {**BASE, **extra}
    variables = perturbed_variables(cfg, 0)
    x = np.random.default_rng(100).standard_normal(
        (3, *cfg["DIM"], 1)).astype(np.float32)
    ref = jax_build_model(cfg).apply(variables, x, train=False)
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables.get("batch_stats")))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    if not isinstance(ref, dict):
        ref, got = {"head": ref}, {"head": got}
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4, rtol=0, err_msg=name)


def test_transpose_forward_matches_flax_mixed_precision():
    ref, got = forward_both({**BASE, "GROUP_NORM": 4, "DEPTH": 2,
                             "MIXED_PRECISION": True}, conv_bias=False)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)


def test_transpose_kernel_round_trips_and_is_flipped():
    cfg = {**BASE, "GROUP_NORM": 4, "DEPTH": 2}
    variables = perturbed_variables(cfg, 1)
    state = flax_to_state_dict(variables["params"])
    flax_kernel = np.asarray(
        variables["params"]["UpBlock_0"]["ConvTranspose_0"]["kernel"])
    torch_kernel = state["UpBlock_0.ConvTranspose_0.weight"].numpy()
    assert torch_kernel.shape == (flax_kernel.shape[2], flax_kernel.shape[3],
                                  *flax_kernel.shape[:2])
    np.testing.assert_array_equal(torch_kernel[:, :, 0, 0],
                                  flax_kernel[-1, -1])
    params, _ = state_dict_to_flax(state)
    np.testing.assert_array_equal(
        params["UpBlock_0"]["ConvTranspose_0"]["kernel"], flax_kernel)


def test_transpose_elu_gradient_matches_flax():
    cfg = {**BASE, "GROUP_NORM": 4, "DEPTH": 2, "ACTIVATION": "elu"}
    variables = perturbed_variables(cfg, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    w = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    flax_model = jax_build_model(cfg)

    def objective(params):
        out = flax_model.apply({"params": params}, x, train=False)
        return jnp.sum(out * w)

    ref = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.grad(objective)(variables["params"])))
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"]))
    torch.sum(model.eval()(torch.from_numpy(x)) * torch.from_numpy(w)
              ).backward()
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
