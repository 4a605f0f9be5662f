"""cmrtpu_torch's 2D-in-3D hybrids, (2+1)D U-Net and deep supervision
against cmrtpu on the CPU, at [2, 4, 32, 32], depth 2, 4 filters.

* Forward against ``model.apply`` on bridged weights, for every
  MODEL_VARIANT cmrtpu builds and for deep supervision in 2D and 3D:
  probabilities within 1e-4 in f32 (sums in another order) and 2e-2 under
  MIXED_PRECISION (bf16 rounds at other places).
* Train-mode BatchNorm: the output and the running averages flax moves,
  the 2D trunk's statistics over B * Z slices.
* ``model.npz`` of each variant both ways, bit for bit; a leaf of no ported
  module still raises; a hybrid or supervised fold of cmrtpu restored by
  the port's ``Predictor``.
* The dispatcher, ``_as_2d_config``, ``model_summary``, the seeded init,
  the frozen 2D trunk and the HEADS + hybrid ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.models.hybrids import _as_2d_config as jax_as_2d_config
from cmrtpu.models.hybrids import get_model as jax_get_model
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.models.hybrids import (Avg2D3D, SliceDistributed2D,
                                         Stacked2D3D, _as_2d_config,
                                         build_hybrid_model, get_model)
from cmrtpu_torch.models.unet import UNet, model_summary
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           load_weights_for_model,
                                           save_weights, state_dict_to_flax)
from test_torch_batchnorm import _flat
from test_torch_checkpoint import _assert_same_npz, _npz, _random_stats
from test_torch_unet import perturbed_variables

torch.set_num_threads(1)

CFG = {"DIM": [4, 32, 32], "F_SIZE": [3, 3, 3], "M_POOL": [1, 2, 2],
       "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 3, "IMG_CHANNELS": 1,
       "MIXED_PRECISION": False, "BATCH_NORMALISATION": True,
       "DROPOUT_MIN": 0.0, "DROPOUT_MAX": 0.0}
HYBRIDS = ["wrapper", "followed", "concat", "avg", "avg_plain"]
# (MODEL_VARIANT, supervision, extra config)
CASES = [(v, False, {}) for v in HYBRIDS] + [
    ("unet_2p1d", False, {}),
    ("unet_2p1d", False, {"BN_FIRST": True, "ACTIVATION": "elu"}),
    ("unet", False, {"FACTORIZED_3D": True, "GROUP_NORM": 2,
                     "USE_UPSAMPLE": False}),
    ("unet", True, {}),
    ("unet", True, {"DIM": [32, 32], "F_SIZE": [3, 3], "M_POOL": [2, 2]}),
    ("unet", True, {"GROUP_NORM": 2, "USE_UPSAMPLE": False}),
    ("unet_2p1d", True, {}),
    ("wrapper", True, {}),
    ("avg", True, {"LOGIT_SOFTCAP": 1.5}),
    ("concat", False, {"GROUP_NORM": 2, "LOGIT_SOFTCAP": 1.5}),
]
IDS = ["wrapper", "followed", "concat", "avg", "avg-plain", "2p1d",
       "2p1d-bn-first-elu", "factorized-gn-transpose", "supervision-3d",
       "supervision-2d", "supervision-gn-transpose", "2p1d-supervision",
       "wrapper-supervision", "avg-supervision-softcap", "concat-gn-softcap"]
PROB_ATOL, BF16_ATOL = 1e-4, 2e-2


def _cfg(variant, extra):
    return {**CFG, "MODEL_VARIANT": variant, **extra}


def _x(cfg, seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, *cfg["DIM"], 1)).astype(np.float32)


def _port(cfg, supervision, variables):
    model = get_model(cfg, supervision=supervision)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables.get("batch_stats")))
    return model


def forward_both(variant, supervision, extra, seed=0, conv_bias=True):
    cfg = _cfg(variant, extra)
    ref_model = jax_get_model(cfg, supervision=supervision)
    variables = perturbed_variables(cfg, seed, conv_bias, model=ref_model)
    x = _x(cfg, seed + 100)
    ref = np.asarray(ref_model.apply(variables, x, train=False))
    with torch.no_grad():
        got = _port(cfg, supervision, variables).eval()(
            torch.from_numpy(x)).numpy()
    return ref, got


@pytest.mark.parametrize("variant,supervision,extra", CASES, ids=IDS)
def test_forward_matches_flax_f32(variant, supervision, extra):
    ref, got = forward_both(variant, supervision, extra)
    assert got.shape == ref.shape
    assert got.shape[-1] == 3
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL, rtol=0)


# bf16 on the cases without GroupNorm: with 2 channels a group the
# reference's own bf16 output lies further than 2e-2 from its f32 output
# at this size (test_reference_bf16_spread_with_small_groups), so 2e-2
# between two bf16 forwards cannot be held there; f32 holds them above
BF16_CASES = [(c, i) for c, i in zip(CASES, IDS)
              if "GROUP_NORM" not in c[2]]
GN_CASES = [(c, i) for c, i in zip(CASES, IDS) if "GROUP_NORM" in c[2]]


@pytest.mark.parametrize("variant,supervision,extra",
                         [c for c, _ in BF16_CASES],
                         ids=[i for _, i in BF16_CASES])
def test_forward_matches_flax_mixed_precision(variant, supervision, extra):
    # conv biases stay at their zero init, as tests/test_torch_unet.py says
    ref, got = forward_both(variant, supervision,
                            dict(extra, MIXED_PRECISION=True), seed=1,
                            conv_bias=False)
    assert got.dtype == np.float32  # the heads run in f32
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("variant,supervision,extra",
                         [c for c, _ in GN_CASES],
                         ids=[i for _, i in GN_CASES])
def test_reference_bf16_spread_with_small_groups(variant, supervision,
                                                 extra):
    """Why the GroupNorm cases are not held in bf16: cmrtpu's own bf16
    forward lies further than the bf16 tolerance from its f32 forward."""
    cfg = _cfg(variant, extra)
    model = jax_get_model(cfg, supervision=supervision)
    variables = perturbed_variables(cfg, 1, conv_bias=False, model=model)
    x = _x(cfg, 101)
    f32 = np.asarray(model.apply(variables, x, train=False))
    bf16_model = jax_get_model(dict(cfg, MIXED_PRECISION=True),
                               supervision=supervision)
    bf16 = np.asarray(bf16_model.apply(variables, x, train=False))
    assert np.abs(bf16 - f32).max() > BF16_ATOL


def test_flax_tree_of_the_factorized_block():
    """The (2+1)D block's leaves: a 2D kernel inside the 3D net, then the
    temporal (3, 1, 1) one; the upsample conv stays 3D."""
    cfg = _cfg("unet_2p1d", {})
    params = perturbed_variables(cfg, 0, model=jax_get_model(cfg))["params"]
    block = params["DownBlock_0"]["ConvBlock_0"]
    assert block["Conv_0"]["kernel"].shape == (3, 3, 1, 4)
    assert block["Conv_1"]["kernel"].shape == (3, 1, 1, 4, 4)
    assert params["UpBlock_1"]["Conv_0"]["kernel"].shape == (3, 3, 3, 8, 4)
    port = get_model(cfg)
    assert isinstance(port.get_submodule("DownBlock_0.ConvBlock_0.Conv_0"),
                      torch.nn.Conv2d)
    assert isinstance(port.get_submodule("UpBlock_1.Conv_0"),
                      torch.nn.Conv3d)
    assert not hasattr(port.get_submodule("UpBlock_1"), "Conv_1")


@pytest.mark.parametrize("variant,supervision", [
    ("wrapper", False), ("avg", False), ("concat", False),
    ("unet_2p1d", False), ("unet", True)],
    ids=["wrapper", "avg", "concat", "2p1d", "supervision"])
def test_bn_train_forward_matches_flax(variant, supervision):
    """Train-mode BatchNorm (the 2D trunk's over B * Z slices): the output
    and the running averages flax moves."""
    cfg = _cfg(variant, {})
    ref_model = jax_get_model(cfg, supervision=supervision)
    variables = perturbed_variables(cfg, 4, model=ref_model)
    x = _x(cfg, 4, batch=3)
    ref, moved = ref_model.apply(
        variables, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(0, impl="threefry2x32")})
    model = _port(cfg, supervision, variables)
    got = model.train()(torch.from_numpy(x),
                        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=PROB_ATOL, rtol=0)
    _, stats = state_dict_to_flax(model.state_dict())
    got_stats, want = _flat(stats), _flat(moved["batch_stats"])
    assert got_stats.keys() == want.keys()
    for name, value in got_stats.items():
        np.testing.assert_allclose(value, want[name], atol=1e-5, rtol=0,
                                   err_msg=name)


def test_wrapper_equals_the_2d_trunk_slice_by_slice():
    model = get_model(_cfg("wrapper", {})).reset_parameters(
        torch.Generator().manual_seed(2)).eval()
    x = torch.from_numpy(_x(CFG, 2))
    with torch.no_grad():
        out = model(x)
        per_slice = torch.stack([model.unet_2d(x[:, z]) for z in range(4)],
                                dim=1)
    torch.testing.assert_close(out, per_slice, atol=2e-6, rtol=0)


@pytest.mark.parametrize("variant", ["followed", "concat", "avg",
                                     "avg_plain"])
def test_softmax_outputs_sum_to_one(variant):
    model = get_model(_cfg(variant, {})).reset_parameters(
        torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        out = model(torch.ones(1, 4, 32, 32, 1))
    torch.testing.assert_close(out.sum(-1), torch.ones(out.shape[:-1]),
                               atol=1e-5, rtol=0)


def test_get_model_dispatch_and_2d_config():
    assert type(get_model({"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4}))\
        is UNet
    types = {v: type(get_model(_cfg(v, {}))) for v in HYBRIDS}
    assert types == {"wrapper": SliceDistributed2D,
                     "followed": Stacked2D3D, "concat": Stacked2D3D,
                     "avg": Avg2D3D, "avg_plain": Avg2D3D}
    assert get_model(_cfg("unet_2p1d", {})).get_submodule(
        "ConvBlock_0").factorized
    concat = get_model(_cfg("concat", {}))
    # the 3D trunk takes MASK_CLASSES (+1 with concat) channels
    assert concat.unet_3d.get_submodule(
        "DownBlock_0.ConvBlock_0.Conv_0").in_channels == 4
    assert get_model(_cfg("followed", {})).unet_3d.get_submodule(
        "DownBlock_0.ConvBlock_0.Conv_0").in_channels == 3
    for cfg in ({"DIM": [16, 64, 64]}, CFG,
                {"DIM": [8, 64, 64], "F_SIZE": [5, 3, 3],
                 "M_POOL": [2, 2, 2]}):
        assert _as_2d_config(cfg) == jax_as_2d_config(cfg)
    with pytest.raises(ValueError, match="unknown hybrid"):
        build_hybrid_model(CFG, variant="stacked")


def test_model_summary_works_for_hybrids():
    summary = model_summary(get_model(_cfg("avg", {})))
    assert summary.startswith("Avg2D3D mask_classes=3")
    assert "unet_2d/DownBlock_0/ConvBlock_0/Conv_0/kernel" in summary
    assert "head_avg/kernel" in summary and "Trainable params" in summary


def test_reset_parameters_is_seeded():
    a, b = (get_model(_cfg("avg", {})).reset_parameters(
        torch.Generator().manual_seed(7)) for _ in range(2))
    for (name, ta), tb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(ta, tb), name
    w = a.head_avg.weight
    assert not a.head_avg.bias.any()
    assert w.abs().max() <= 2 * np.sqrt(2.0 / 3) / 0.87962566103423978 + 1e-7


def test_frozen_2d_trunk_runs_in_eval_mode_without_gradient():
    model = get_model(_cfg("followed", {})).reset_parameters(
        torch.Generator().manual_seed(4))
    model.freeze_2d = True
    model.train()
    assert not model.unet_2d.training and model.unet_3d.training
    before = model.unet_2d.get_submodule(
        "DownBlock_0.ConvBlock_0.BatchNorm_0").running_mean.clone()
    out = model(torch.from_numpy(_x(CFG, 4)),
                generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert all(p.grad is None for p in model.unet_2d.parameters())
    assert model.unet_3d.head.weight.grad is not None
    assert torch.equal(before, model.unet_2d.get_submodule(
        "DownBlock_0.ConvBlock_0.BatchNorm_0").running_mean)


@pytest.mark.parametrize("variant", ["wrapper", "avg"])
def test_heads_with_a_hybrid_raise(variant):
    cfg = _cfg(variant, {"HEADS": [["lm", 2, "sigmoid"],
                                   ["seg", 3, "softmax"]]})
    with pytest.raises(ValueError, match="with HEADS"):
        get_model(cfg)
    # cmrtpu builds the model and fails at its first forward
    with pytest.raises(AttributeError, match="reshape"):
        jax_get_model(cfg).init(jax.random.key(0, impl="threefry2x32"),
                                jnp.zeros((1, *cfg["DIM"], 1)), train=False)


@pytest.mark.parametrize("variant,supervision", [
    ("wrapper", False), ("followed", False), ("concat", False),
    ("avg", False), ("avg_plain", False), ("unet_2p1d", False),
    ("unet", True)],
    ids=["wrapper", "followed", "concat", "avg", "avg-plain", "2p1d",
         "supervision"])
def test_npz_round_trips_both_ways(variant, supervision, tmp_path):
    cfg = _cfg(variant, {})
    ref_model = jax_get_model(cfg, supervision=supervision)
    variables = perturbed_variables(cfg, 3, model=ref_model)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_ckpt.save_weights(a, variables["params"], variables["batch_stats"])
    model = load_weights_for_model(
        a, get_model(cfg, supervision=supervision), cfg)
    save_weights(b, model)
    _assert_same_npz(_npz(a), _npz(b))

    # the port's npz in cmrtpu: written back unchanged, the same forward
    port = _random_stats(get_model(cfg, supervision=supervision)
                         .reset_parameters(torch.Generator().manual_seed(5)),
                         seed=5)
    c, d = str(tmp_path / "c"), str(tmp_path / "d")
    save_weights(c, port)
    params, stats = jax_ckpt.load_weights(c)
    jax_ckpt.save_weights(d, params, stats)
    _assert_same_npz(_npz(c), _npz(d))
    x = _x(cfg, 0, batch=1)
    want = np.asarray(ref_model.apply({"params": params,
                                       "batch_stats": stats}, x,
                                      train=False))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


def test_bridge_still_rejects_foreign_leaves():
    """A ScaleLayer's scalar, a 6D kernel and a weight of no conv or norm
    raise both ways, inside a hybrid's trunk too."""
    with pytest.raises(ValueError, match="not a leaf"):
        flax_to_state_dict({"unet_2d": {"ScaleLayer_0": {
            "scale": np.ones((), np.float32)}}})
    with pytest.raises(ValueError, match="not a leaf"):
        flax_to_state_dict({"head_avg": {
            "kernel": np.zeros((1, 1, 1, 1, 3, 3), np.float32)}})
    with pytest.raises(ValueError, match="no flax counterpart"):
        state_dict_to_flax({"unet_3d.ScaleLayer_0.scale": torch.ones(())})


@pytest.mark.parametrize("variant,supervision", [
    ("wrapper", False), ("avg", False), ("unet_2p1d", False),
    ("unet", True), ("wrapper", True)],
    ids=["wrapper", "avg", "2p1d", "supervision", "wrapper-supervision"])
def test_cmrtpu_fold_restores_through_the_ports_predictor(
        variant, supervision, tmp_path):
    """A fold cmrtpu's Trainer saved serves from the port's Predictor as
    cmrtpu's Trainer.predict computes it. With deep supervision the port
    builds the branch its weights hold; cmrtpu's Predictor drops it."""
    from cmrtpu.predict.predictor import Predictor as JaxPredictor
    from cmrtpu.train.trainer import Trainer as JaxTrainer

    cfg = {"DIM": [4, 16, 16], "DEPTH": 1, "FILTERS": 2, "MASK_CLASSES": 2,
           "M_POOL": [1, 2, 2], "F_SIZE": [3, 3, 3], "IMG_CHANNELS": 1,
           "BATCHSIZE": 2, "LEARNING_RATE": 1e-3, "MIXED_PRECISION": False,
           "SEED": 0, "MODEL_VARIANT": variant, "PRNG_IMPL": ""}
    trainer = JaxTrainer(cfg, supervision=supervision)
    model_dir = str(tmp_path / "model")
    jax_ckpt.save_weights(model_dir, trainer.state.params,
                          trainer.state.batch_stats)
    x = np.random.default_rng(0).normal(size=(3, 4, 16, 16, 1)).astype(
        np.float32)
    want = np.asarray(trainer.predict(x))
    got = Predictor(cfg, model_dir, device="cpu").predict(x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ref_served = JaxPredictor(dict(cfg, MODEL_PATH=model_dir)).predict(x)
    assert (np.abs(ref_served - want).max() > 1e-3) == supervision
