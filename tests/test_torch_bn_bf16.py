"""BN_BF16 in cmrtpu_torch against cmrtpu's ``BF16BatchNorm``.

* BN_BF16 keeps the state_dict of float32 BatchNorm (checkpoints
  interchange) and builds only under MIXED_PRECISION, as cmrtpu's.
* ``BF16BatchNorm`` alone: its float32 statistics of a bf16 input within
  1e-5 of float64's, its running averages moved by momentum 0.99, and its
  output in bf16, within one bf16 ulp of the largest |y| of x * inv +
  (bias - mean * inv) with inv and the shift rounded to bf16.
* The U-Net's eval forward on cmrtpu's weights within 2e-2 of cmrtpu's
  BN_BF16 forward (the MIXED_PRECISION bound of tests/test_torch_unet.py),
  and within 0.03 of the float32-BatchNorm forward of the same weights
  (cmrtpu's ``test_bn_bf16_checkpoint_interchange_and_numerics``).
* One train-mode step (dropout 0): the running averages within rtol 1e-2
  of cmrtpu's (float32 statistics of bf16 activations that the two
  frameworks round differently; measured 1.2e-3) and the loss within rel
  1e-2. A bf16 net's gradients are mostly rounding: cmrtpu's BN_BF16
  gradients lie 0.75 of the largest |g| from its float32 net's, and the
  port's lie as far from cmrtpu's. So the gradients are held to the
  float32 net: the port's BN_BF16 gradients may lie from cmrtpu's float32
  ones at most 1.25x as far as cmrtpu's BN_BF16 gradients do (measured
  0.22 against 0.75).
* ``model.npz`` both ways.
"""

import jax
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.models.unet import BatchNorm, BF16BatchNorm, build_model
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict, load_weights,
                                           save_weights, state_dict_to_flax)
from test_torch_unet import perturbed_variables

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 3, "FILTERS": 8, "MASK_CLASSES": 2,
       "MIXED_PRECISION": True, "BATCH_NORMALISATION": True,
       "BN_BF16": True, "DROPOUT_MIN": 0.0, "DROPOUT_MAX": 0.0}
F32_BN = dict(CFG, BN_BF16=False)
BF16_ATOL = 2e-2
STATS_RTOL = 1e-2
LOSS_RTOL = 1e-2
GRAD_FACTOR = 1.25


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port(cfg, variables):
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    return model


@pytest.fixture(scope="module")
def case():
    variables = perturbed_variables(CFG, 1, conv_bias=False)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 1)).astype(np.float32)
    y = (rng.random((4, 32, 32, 2)) > 0.9).astype(np.float32)
    return variables, x, y


def test_same_state_dict_and_mixed_precision_only():
    assert set(build_model(CFG).state_dict()) == \
        set(build_model(F32_BN).state_dict())
    block = build_model(CFG).DownBlock_0.ConvBlock_0
    assert isinstance(block.BatchNorm_0, BF16BatchNorm) and block.bn_bf16
    f32 = build_model(dict(CFG, MIXED_PRECISION=False))
    assert type(f32.DownBlock_0.ConvBlock_0.BatchNorm_0) is BatchNorm


def test_bf16_batchnorm_alone():
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 3, 5, 6, generator=gen) * 3 + 2).to(torch.bfloat16)
    bn = BF16BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    out = bn.train()(x)
    assert out.dtype == torch.bfloat16
    x64 = x.double()
    mean = x64.mean(dim=(0, 2, 3))
    var = x64.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean.double(), 0.01 * mean,
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.running_var.double(), 0.99 + 0.01 * var,
                               rtol=1e-5, atol=1e-7)
    # the normalise step: one multiply and one add in bf16
    mean32 = x.float().mean(dim=(0, 2, 3))
    var32 = torch.clamp(x.float().square().mean(dim=(0, 2, 3))
                        - mean32.square(), min=0.0)
    inv = bn.weight * torch.rsqrt(var32 + 1e-3)
    want = (x * inv.to(torch.bfloat16)[:, None, None]
            + (bn.bias - mean32 * inv).to(torch.bfloat16)[:, None, None])
    assert (out.float() - want.float()).abs().max() <= 2 ** -7 * \
        want.float().abs().max()
    # eval mode reads the running averages and moves nothing
    before = bn.running_mean.clone()
    with torch.no_grad():
        bn.eval()(x)
    assert torch.equal(bn.running_mean, before)


def test_eval_forward_matches_cmrtpu(case):
    variables, x, _ = case
    ref = np.asarray(jax_build_model(CFG).apply(variables, x, train=False))
    f32 = np.asarray(jax_build_model(F32_BN).apply(variables, x,
                                                    train=False))
    with torch.no_grad():
        got = _port(CFG, variables).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(got, f32, rtol=0, atol=0.03)


def _jax_step(cfg, variables, x, y):
    model = jax_build_model(cfg)

    def f(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True,
                               rngs={"dropout": jax.random.key(0)},
                               mutable=["batch_stats"])
        return ((out - y) ** 2).mean(), mut

    (loss, mut), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    return float(loss), _flat(grads), _flat(mut["batch_stats"])


def _gap(a, b):
    """max |a - b| over every leaf, over the largest |b|."""
    return max(np.abs(a[k] - b[k]).max() for k in b) / max(
        np.abs(v).max() for v in b.values())


def test_train_step_matches_cmrtpu(case):
    variables, x, y = case
    want_loss, want_g, want_s = _jax_step(CFG, variables, x, y)
    _, f32_g, _ = _jax_step(dict(CFG, MIXED_PRECISION=False), variables, x,
                            y)

    port = _port(CFG, variables).train()
    out = port(torch.from_numpy(x), generator=torch.Generator())
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    params, stats = state_dict_to_flax(
        {**{n: p.grad for n, p in port.named_parameters()},
         **dict(port.named_buffers())})
    got_g, got_s = _flat(params), _flat(stats)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert got_g.keys() == want_g.keys()
    assert _gap(got_g, f32_g) <= GRAD_FACTOR * _gap(want_g, f32_g)
    for name, s in want_s.items():
        np.testing.assert_allclose(got_s[name], s, rtol=STATS_RTOL,
                                   atol=1e-6, err_msg=name)


def test_npz_both_ways(case, tmp_path):
    variables, x, _ = case
    ref = np.asarray(jax_build_model(CFG).apply(variables, x, train=False))
    jax_ckpt.save_weights(str(tmp_path / "jax"), variables["params"],
                          variables["batch_stats"])
    params, stats = load_weights(str(tmp_path / "jax"))
    model = _port(CFG, {"params": params, "batch_stats": stats}).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_ATOL)
    save_weights(str(tmp_path / "port"), model)
    p2, s2 = jax_ckpt.load_weights(str(tmp_path / "port"))
    back = np.asarray(jax_build_model(CFG).apply(
        {"params": p2, "batch_stats": s2}, x, train=False))
    np.testing.assert_array_equal(back, ref)
