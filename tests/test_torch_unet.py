"""cmrtpu_torch's U-Net against cmrtpu's flax U-Net on bridged weights.

The same seeded numpy input goes through ``model.apply(..., train=False)``
and the port's eval forward. Tolerances: 1e-4 on probabilities in f32 (the
convolutions sum in another order); 2e-2 under MIXED_PRECISION, where bf16
rounds at different places in the two frameworks."""

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import effective_pools as jax_effective_pools
from cmrtpu.models.unet import init_variables
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import build_model, effective_pools
from cmrtpu_torch.train.checkpoint import flax_to_state_dict

torch.set_num_threads(1)

BASE = {"DIM": [32, 32], "DEPTH": 3, "FILTERS": 8, "MASK_CLASSES": 2,
        "MIXED_PRECISION": False}


def perturbed_variables(cfg, seed, conv_bias=True, model=None):
    """flax init of ``model`` (default: cfg's U-Net), with norm
    scales/biases, running stats and (optionally) conv biases moved off
    their trivial init values so every leaf matters. The key's PRNG is
    pinned: another test in the same process may switch jax's default
    (cmrtpu's Trainer sets PRNG_IMPL), which would draw other weights."""
    variables = init_variables(model or jax_build_model(cfg), cfg,
                               jax.random.key(seed, impl="threefry2x32"))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = path[-1].key
        if name == "bias" and path[-2].key.startswith("Conv") \
                and not conv_bias:
            return a
        if name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(a.shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.standard_normal(a.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, dict(variables))


def forward_both(cfg, seed=0, batch=3, conv_bias=True):
    variables = perturbed_variables(cfg, seed, conv_bias)
    c = cfg.get("IMG_CHANNELS", 1)
    x = np.random.default_rng(seed + 100).standard_normal(
        (batch, *cfg["DIM"], c)).astype(np.float32)
    ref = np.asarray(jax_build_model(cfg).apply(variables, x, train=False))
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables.get("batch_stats")))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return ref, got


@pytest.mark.parametrize("extra", [
    {"GROUP_NORM": 4},
    {"GROUP_NORM": 3, "DIM": [32, 48]},   # 3 does not divide 8: groups -> 2
    {"BATCH_NORMALISATION": True},
    {"BATCH_NORMALISATION": True, "BN_FIRST": True, "ACTIVATION": "elu"},
    {"BATCH_NORMALISATION": False, "LOGIT_SOFTCAP": 2.0, "DEPTH": 2},
], ids=["gn", "gn-uneven-groups", "bn", "bn-first-elu", "no-norm-softcap"])
def test_forward_matches_flax_f32(extra):
    ref, got = forward_both({**BASE, **extra})
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("extra", [
    {"GROUP_NORM": 4, "DEPTH": 2}, {"BATCH_NORMALISATION": True},
], ids=["gn", "bn"])
def test_forward_matches_flax_mixed_precision(extra):
    # conv biases stay at their zero init: random ones leave relu channels
    # nearly dead ahead of the norm, whose tiny variance then amplifies bf16
    # rounding (the reference's own bf16 output is then 0.1 off its f32 one)
    ref, got = forward_both({**BASE, **extra, "MIXED_PRECISION": True},
                            conv_bias=False)
    assert got.dtype == np.float32  # the head runs in f32
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("spatial,m_pool,depth", [
    ((224, 224), (2, 2), 4), ((8, 64), (2, 2), 4), ((3, 32), (2, 2), 3)])
def test_effective_pools_matches(spatial, m_pool, depth):
    assert effective_pools(spatial, m_pool, depth) == \
        jax_effective_pools(spatial, m_pool, depth)


def test_reset_parameters_is_seeded_he_normal():
    cfg = {**BASE, "GROUP_NORM": 4, "HEAD_BIAS_PRIOR": 0.01}
    a = build_model(cfg).reset_parameters(torch.Generator().manual_seed(7))
    b = build_model(cfg).reset_parameters(torch.Generator().manual_seed(7))
    for (name, ta), tb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(ta, tb), name
    w = a.get_submodule("DownBlock_1.ConvBlock_0.Conv_0").weight
    std = np.sqrt(2.0 / w[0].numel()) / 0.87962566103423978
    assert w.abs().max() <= 2 * std + 1e-7  # truncated at two std
    assert w.std().item() == pytest.approx(np.sqrt(2.0 / w[0].numel()),
                                           rel=0.15)
    assert a.head.bias.detach().numpy() == pytest.approx(
        np.log(0.01 / 0.99), rel=1e-6)


@pytest.mark.parametrize("extra,error,match", [
    # the int8 twin builds now (tests/test_torch_quantize.py); what stays
    # unported of it is the factorized (2+1)D twin, refused as cmrtpu's
    # quantize_model refuses it
    ({"QUANT_INT8": True, "FACTORIZED_3D": True}, ValueError,
     "does not support factorized"),
    # weight standardisation builds under cmrtpu's acknowledgement
    # (tests/test_torch_ws.py) and raises without it, as cmrtpu's factory
    ({"WEIGHT_STANDARDISATION": True}, ValueError, "WS_I_UNDERSTAND"),
], ids=["int8", "ws"])
def test_unported_configs_raise(extra, error, match):
    with pytest.raises(error, match=match):
        get_model({**BASE, **extra})
