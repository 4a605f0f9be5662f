"""cmrtpu_torch's ConvEncoder and ConvDecoder against cmrtpu's flax ones.

The composed model of
``tests/test_model.py::test_conv_encoder_decoder_compose`` (encoder depth
2, filters 4; decoder filters 8; a 1x1 head, here with a sigmoid) is
built in both packages; flax's weights load into the port through
``flax_to_state_dict`` under flax's auto-names. Tolerances:
1e-4 on probabilities in f32 and 2e-2 in bf16, as the U-Net's
(``tests/test_torch_unet.py``). Dropout is compared at rates 0 and 1 only,
which draw nothing in either package."""

import warnings
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

from cmrtpu.models.unet import ConvDecoder as JaxConvDecoder
from cmrtpu.models.unet import ConvEncoder as JaxConvEncoder
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.train.checkpoint import load_weights as jax_load_weights
from cmrtpu.train.checkpoint import save_weights as jax_save_weights
from cmrtpu_torch.models.unet import (ConvDecoder, ConvEncoder,
                                      effective_pools, init_weights_)
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict, load_weights,
                                           save_weights)
from cmrtpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


class FlaxComposed(fnn.Module):
    """The composed model of tests/test_model.py:103 with a sigmoid head."""
    depth: int = 2
    filters: int = 4
    group_norm: int = 0
    enc_drop: Tuple[float, ...] = (0.1, 0.2)
    drop_bottleneck: float = 0.5
    dec_drop: Tuple[float, ...] = (0.1, 0.2)
    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x, train=False):
        enc, skips = JaxConvEncoder(
            depth=self.depth, filters=self.filters, dropouts=self.enc_drop,
            drop_bottleneck=self.drop_bottleneck, group_norm=self.group_norm,
            dtype=self.dtype)(x, train)
        x = JaxConvDecoder(
            depth=self.depth, filters=self.filters * 2 ** (self.depth - 1),
            dropouts=self.dec_drop, group_norm=self.group_norm,
            dtype=self.dtype)(enc, skips, train)
        return fnn.sigmoid(fnn.Conv(2, (1, 1))(x))


class Composed(nn.Module):
    """The same model built from the port's blocks."""

    def __init__(self, depth=2, filters=4, group_norm=0, enc_drop=(0.1, 0.2),
                 drop_bottleneck=0.5, dec_drop=(0.1, 0.2), up_size=(2, 2),
                 dtype=torch.float32):
        super().__init__()
        self.ConvEncoder_0 = ConvEncoder(
            depth=depth, filters=filters, dropouts=enc_drop,
            drop_bottleneck=drop_bottleneck, group_norm=group_norm,
            dtype=dtype)
        self.ConvDecoder_0 = ConvDecoder(
            depth=depth, filters=filters * 2 ** (depth - 1),
            dropouts=dec_drop, up_size=up_size, group_norm=group_norm,
            dtype=dtype)
        self.Conv_0 = nn.Conv2d(filters, 2, 1)

    def forward(self, x, generator=None):
        enc, skips = self.ConvEncoder_0(x, generator)
        y = self.ConvDecoder_0(enc, skips, generator)
        y = torch.movedim(y, -1, 1).float()
        return torch.movedim(torch.sigmoid(self.Conv_0(y)), 1, -1)


def _key(seed):
    # pinned: another test in the worker may switch jax's default PRNG
    return jax.random.key(seed, impl="threefry2x32")


def _perturbed(variables, seed):
    """Norm scales, biases and running stats moved off their init values,
    so that every leaf matters."""
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = path[-1].key
        if name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(a.shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.standard_normal(a.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, dict(variables))


def _input(shape, seed=100):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bridged(variables, model):
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables.get("batch_stats")))
    return model


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("group_norm", [0, 2], ids=["bn", "gn"])
def test_composed_model_matches_flax(dtype, group_norm):
    jdt, tdt, atol = _DTYPES[dtype]
    x = _input((2, 32, 32, 1))
    flax_model = FlaxComposed(group_norm=group_norm, dtype=jdt)
    variables = _perturbed(flax_model.init(_key(0), x), 1)
    # the weights bridge maps the composed tree by module kind, no new rule
    assert "kernel" in variables["params"]["ConvEncoder_0"]["DownBlock_0"][
        "ConvBlock_0"]["Conv_0"]
    ref = np.asarray(flax_model.apply(variables, x, train=False), np.float32)
    model = _bridged(variables, Composed(group_norm=group_norm, dtype=tdt))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_encoder_clamps_pools_as_cmrtpu():
    """A 16x8 input at depth 4 runs out of the 8 axis: both packages warn
    with the same text and compute the same encoding and skips."""
    x = _input((2, 16, 8, 1))
    flax_enc = JaxConvEncoder(depth=4, filters=2, dtype=jnp.float32)
    variables = _perturbed(flax_enc.init(_key(2), x, train=False), 3)
    with warnings.catch_warnings(record=True) as jax_warns:
        warnings.simplefilter("always")
        ref_enc, ref_skips = flax_enc.apply(variables, x, train=False)
    enc = _bridged(variables, ConvEncoder(depth=4, filters=2,
                                          dtype=torch.float32)).eval()
    with warnings.catch_warnings(record=True) as port_warns, \
            torch.no_grad():
        warnings.simplefilter("always")
        got_enc, got_skips = enc(torch.from_numpy(x))
    jax_msgs = [str(w.message) for w in jax_warns
                if "ConvEncoder" in str(w.message)]
    port_msgs = [str(w.message) for w in port_warns
                 if "ConvEncoder" in str(w.message)]
    assert len(jax_msgs) == 1 and port_msgs == jax_msgs
    assert "((2, 2), (2, 2), (2, 2), (2, 1))" in port_msgs[0]
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(ref_enc),
                               atol=1e-4, rtol=0)
    assert len(got_skips) == len(ref_skips) == 4
    for got, want in zip(got_skips, ref_skips):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("dec_drop", [(1.0, 0.0), (0.0, 1.0)],
                         ids=["deepest-zeroed", "shallowest-zeroed"])
def test_decoder_dropout_applies_in_forward_order(dec_drop):
    """In train mode a rate of 1 zeroes its block's input in both packages
    and a rate of 0 keeps it, so they agree with no shared draws; the
    swapped order does not."""
    x = _input((2, 32, 32, 1), seed=4)
    kw = dict(group_norm=2, enc_drop=(0.0, 0.0), drop_bottleneck=0.0)
    flax_model = FlaxComposed(dec_drop=dec_drop, **kw)
    variables = _perturbed(flax_model.init(_key(5), x), 6)
    ref = np.asarray(flax_model.apply(variables, x, train=True,
                                      rngs={"dropout": _key(7)}))
    outs = {}
    for order in (dec_drop, dec_drop[::-1]):
        model = _bridged(variables, Composed(dec_drop=order, **kw)).train()
        with torch.no_grad():
            outs[order] = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(outs[dec_drop], ref, atol=1e-4, rtol=0)
    assert np.abs(outs[dec_drop[::-1]] - ref).max() > 1e-2


def _as_composed(unet_params):
    """cmrtpu's U-Net tree in the composed model's layout: the DownBlocks
    and the bottleneck under ConvEncoder_0, the UpBlocks under
    ConvDecoder_0, the head as Conv_0."""
    enc = {k: v for k, v in unet_params.items()
           if k.startswith(("DownBlock", "ConvBlock"))}
    dec = {k: v for k, v in unet_params.items() if k.startswith("UpBlock")}
    return {"ConvEncoder_0": enc, "ConvDecoder_0": dec,
            "Conv_0": unet_params["head"]}


def test_per_level_up_size_mirrors_a_clamped_encoder():
    """With the clamped pools reversed as its per-level up_size, the
    composed model computes cmrtpu's U-Net on a 16x8 input at depth 4,
    whose decoder mirrors the clamped pools; a single tuple there cannot
    (the skips' sizes differ), in cmrtpu as in the port."""
    cfg = {"DIM": [16, 8], "DEPTH": 4, "FILTERS": 2, "MASK_CLASSES": 2,
           "MIXED_PRECISION": False, "GROUP_NORM": 2}
    x = _input((2, 16, 8, 1), seed=8)
    unet = jax_build_model(cfg)
    variables = _perturbed(unet.init(_key(9), x, train=False), 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.asarray(unet.apply(variables, x, train=False))
    pools, clamped = effective_pools((16, 8), (2, 2), 4)
    assert clamped
    params = _as_composed(variables["params"])
    model = Composed(depth=4, filters=2, group_norm=2, up_size=pools[::-1],
                     enc_drop=(0.3, 0.4, 0.4, 0.5),
                     dec_drop=(0.5, 0.4, 0.4, 0.3))
    model.load_state_dict(flax_to_state_dict(params))
    single = Composed(depth=4, filters=2, group_norm=2,
                      enc_drop=(0.3, 0.4, 0.4, 0.5),
                      dec_drop=(0.5, 0.4, 0.4, 0.3))
    single.load_state_dict(flax_to_state_dict(params))
    with warnings.catch_warnings(), torch.no_grad():
        warnings.simplefilter("ignore")
        got = model.eval()(torch.from_numpy(x)).numpy()
        with pytest.raises(RuntimeError):
            single.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # the per-level form of one repeated tuple is the single tuple
    per_level = ConvDecoder(depth=2, filters=8, up_size=[(2, 2), (2, 2)])
    assert per_level.up_size == ConvDecoder(depth=2, filters=8).up_size
    with pytest.raises(ValueError):
        ConvDecoder(depth=2, filters=8, up_size=[(2, 2)])


def test_trainer_trains_a_composed_model(tmp_path):
    """Trainer(cfg, model=composed) takes two steps on the CPU; its
    model.npz loads into cmrtpu's flax model with the same outputs, and
    cmrtpu's rewrite of that tree loads back bit for bit."""
    cfg = {"DIM": [32, 32], "BATCHSIZE": 2, "MASK_CLASSES": 2,
           "LEARNING_RATE": 1e-3, "OPTIMIZER": "adam", "SEED": 0,
           "MIXED_PRECISION": False}
    model = Composed(group_norm=2)
    init_weights_(model, torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model=model, device="cpu")
    rng = np.random.default_rng(11)
    batches = [(rng.standard_normal((2, 32, 32, 1)).astype(np.float32),
                (rng.random((2, 32, 32, 2)) < 0.2).astype(np.float32))
               for _ in range(2)]
    hist = trainer.fit(batches, epochs=1)
    assert trainer.state.step == 2 and np.isfinite(hist[0]["loss"])
    assert any(not torch.equal(start[k], v)
               for k, v in model.state_dict().items())
    save_weights(str(tmp_path / "port"), trainer.serving_params)

    params, stats = jax_load_weights(str(tmp_path / "port"))
    x = _input((3, 32, 32, 1), seed=12)
    ref = np.asarray(FlaxComposed(group_norm=2).apply(
        {"params": params, "batch_stats": stats}, x, train=False))
    np.testing.assert_allclose(trainer.predict(x), ref, atol=1e-4, rtol=0)

    jax_save_weights(str(tmp_path / "ref"), params, stats)
    back = Composed(group_norm=2)
    back.load_state_dict(flax_to_state_dict(*load_weights(
        str(tmp_path / "ref"))))
    for name, tensor in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], tensor), name
