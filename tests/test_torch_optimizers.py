"""cmrtpu_torch's optimizer rules against optax (through cmrtpu's
``get_optimizer``) on the CPU.

Each rule, with and without AGC 0.08, on the parameters of a depth-1
U-Net with the upsample decoder and of one with the transpose-conv decoder
(whose [in, out, kh, kw] weights reduce their AGC units over dims
(0, 2, 3)): 10
steps from the same weights and gradients, the learning rate set anew at
step 5. Each step's updates lie within 1e-6 x max |update| of optax's per
tensor and the weights within 1e-6 x max |w|: the same float32 arithmetic
in another order (AGC's unit sums in float64 here, float32 in optax).
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.train import optimizers as jax_opt
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.train import optimizers as O
from cmrtpu_torch.train.checkpoint import flax_to_state_dict

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 1, "FILTERS": 4, "MASK_CLASSES": 2,
       "GROUP_NORM": 4, "MIXED_PRECISION": False, "LEARNING_RATE": 1e-2,
       "EPSILON": 1e-7}
RTOL = 1e-6
STEPS, LR_STEP, LR2 = 10, 5, 3e-3
# optax's AGC alone and apply_updates, each compiled once per layout
_CLIP = optax.adaptive_grad_clip(0.08, eps=1e-3)
_clip_update = jax.jit(_CLIP.update)
_apply_updates = jax.jit(optax.apply_updates)
RULES = {"adam": {}, "nadam": {}, "sgd": {}, "sgd-momentum": {"MOMENTUM": 0.9},
         "adagrad": {}, "rmsprop": {}, "adadelta": {}, "radam": {}}


@functools.lru_cache(maxsize=None)
def _flax_params(layout, key):
    cfg = dict(CFG, USE_UPSAMPLE=layout == "upsample")
    variables = init_variables(jax_build_model(cfg), cfg,
                               jax.random.key(key, impl="threefry2x32"))
    return cfg, jax.tree_util.tree_map(np.array, dict(variables["params"]))


def _setup(layout, key):
    cfg, params = _flax_params(layout, key)
    model = get_model(cfg)
    model.load_state_dict(flax_to_state_dict(params))
    return cfg, params, model


def _grads(params, rng):
    """Gradients of assorted scales per leaf, so AGC clips some units and
    leaves others."""
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-3, 0))
        .astype(np.float32), params)


def _to_torch(tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _close(got, want, what):
    for name, ref in want.items():
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=RTOL * scale, err_msg=f"{what} {name}")


@pytest.mark.parametrize("agc", [None, 0.08], ids=["plain", "agc"])
@pytest.mark.parametrize("layout", ["upsample", "transpose"])
@pytest.mark.parametrize("rule", list(RULES))
def test_rule_matches_optax(rule, layout, agc):
    cfg, params, model = _setup(layout, 1)
    cfg = dict(cfg, OPTIMIZER=rule.split("-")[0], AGC=agc, **RULES[rule])
    ref_opt = jax_opt.get_optimizer(cfg)
    ref_state = ref_opt.init(params)
    update = jax.jit(ref_opt.update)  # as cmrtpu's train step runs it
    opt = O.get_optimizer(model.named_parameters(), cfg)
    assert opt.name == cfg["OPTIMIZER"]
    names = [n for n, _ in model.named_parameters()]
    plist = [p for _, p in model.named_parameters()]
    rng = np.random.default_rng(2)
    clipped = None
    for step in range(STEPS):
        if step == LR_STEP:
            ref_state = jax_opt.set_learning_rate(ref_state, LR2)
            O.set_learning_rate(opt, LR2)
            assert O.get_learning_rate(opt) == \
                jax_opt.get_learning_rate(ref_state)
        grads = _grads(params, rng)
        if agc and step == 0:
            g_clip, _ = _clip_update(grads, _CLIP.init(params), params)
            clipped = [not np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(grads),
                jax.tree_util.tree_leaves(g_clip))]
        updates, ref_state = update(grads, ref_state, params)
        params = jax.tree_util.tree_map(np.array,
                                        _apply_updates(params, updates))
        g_port = _to_torch(grads)
        got = opt.updates(plist, [torch.from_numpy(g_port[n])
                                  for n in names])
        _close({n: u.numpy() for n, u in zip(names, got)},
               _to_torch(updates), f"step {step} update")
        with torch.no_grad():
            torch._foreach_add_(plist, got)
    _close({n: p.detach().numpy() for n, p in zip(names, plist)},
           _to_torch(params), "weights")
    if agc:  # the test reaches both sides of the clip
        assert any(clipped) and not all(clipped)


def test_unknown_name_is_adam_and_state_roundtrips():
    cfg, _, model = _setup("upsample", 3)
    opt = O.get_optimizer(model.named_parameters(),
                          dict(cfg, OPTIMIZER="Adamax"))
    assert opt.name == "adam"
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    again = O.get_optimizer(model.named_parameters(), cfg)
    again.load_state_dict(opt.state_dict())
    assert again.param_groups[0]["count"] == 1
    for p in model.parameters():
        for key in ("mu", "nu"):
            assert torch.equal(again.state[p][key], opt.state[p][key])


@pytest.mark.parametrize("shape,name,dims", [
    ((8, 4, 3, 3), "DownBlock_0.ConvBlock_0.Conv_0.weight", (1, 2, 3)),
    ((8, 4, 3, 3), "UpBlock_0.ConvTranspose_0.weight", (0, 2, 3)),
    ((8,), "UpBlock_0.ConvTranspose_0.bias", None),
    ((2, 1, 1, 1), "Conv_0.weight", None),
], ids=["conv", "transpose", "bias", "squeezed"])
def test_agc_unit_dims(shape, name, dims):
    """optax's unitwise_norm in the torch layout: one unit per output
    channel of a kernel, the whole tensor when at most one dim is not 1."""
    assert O._unit_dims(name, shape) == dims
