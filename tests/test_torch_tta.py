"""cmrtpu_torch's rot90 test-time augmentation against cmrtpu's
(``cmrtpu/predict/tta.py``).

One set of numpy weights (a flax init, bridged into the port's U-Net) and
one input go through both packages' TTA on the CPU. probs: f32 within 1e-4,
bf16 within 2e-2 (the U-Net's own tolerances, tests/test_torch_unet.py).
coords: where the identity member is confirmed its map passes through
(within 1e-4, the forward's own f32 tolerance); elsewhere the 3 x 3 stamps'
centres are equal, except where a mean coordinate lies within 1e-3 of a .5
tie, which float32 sums in another order may round the other way."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict import tta as JT
from cmrtpu.predict.predictor import Predictor as JaxPredictor
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.predict import tta as T
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train.checkpoint import flax_to_state_dict

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
       "BATCHSIZE": 4, "MIXED_PRECISION": False, "GROUP_NORM": 4,
       "SEED": 3}


def _pair(cfg, seed=3, head_scale=1.0):
    """(flax model, variables, port model) with the same weights; the head
    kernel scaled so thresholded maps have margins."""
    jm = jax_build_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(init_variables(
        jm, cfg, jax.random.key(seed, impl="threefry2x32"))))
    if "head" in variables["params"]:
        variables["params"]["head"] = {
            "kernel": variables["params"]["head"]["kernel"] * head_scale,
            "bias": variables["params"]["head"]["bias"]}
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables.get("batch_stats")))
    return jm, variables, model.eval()


def _x(shape=(3, 32, 32, 1), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_orbit_selection():
    assert T.rot90_orbit([32, 32]) == JT.rot90_orbit([32, 32]) == (0, 1, 2, 3)
    assert T.rot90_orbit([48, 32]) == JT.rot90_orbit([48, 32]) == (0, 2)
    assert T.rot90_orbit([8, 32, 32]) == (0, 1, 2, 3)


@pytest.mark.parametrize("bf16,atol", [(False, 1e-4), (True, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", [[32, 32], [32, 24]], ids=["square", "wide"])
def test_probs_matches_cmrtpu(bf16, atol, dim):
    cfg = dict(CFG, MIXED_PRECISION=bf16, DIM=dim)
    jm, variables, model = _pair(cfg)
    x = _x((3, *dim, 1))
    want = np.asarray(JT.tta_rot90_forward(
        lambda v, a: jm.apply(v, a, train=False), dim)(variables, x))
    with torch.no_grad():
        got = T.tta_rot90_forward(model, dim)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_probs_averages_head_by_head():
    cfg = dict(CFG, HEADS=[["rvip", 2, "sigmoid"], ["seg", 3, "softmax"]])
    jm, variables, model = _pair(cfg)
    x = _x()
    want = JT.tta_forward_from_config(
        lambda v, a: jm.apply(v, a, train=False), cfg)(variables, x)
    with torch.no_grad():
        got = T.tta_forward_from_config(model, cfg)(torch.from_numpy(x))
    assert set(got) == set(want) == {"rvip", "seg"}
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, rtol=0)


def _landmark_maps(rng, n=4, hw=32):
    """Synthetic [n, hw, hw, 2] sigmoid-like maps: a bright blob per
    channel at a random place, with noise."""
    maps = rng.random((n, hw, hw, 2)).astype(np.float32) * 0.3
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        for c in range(2):
            cy, cx = rng.uniform(4, hw - 5, 2)
            maps[i, ..., c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                      / 6.0).astype(np.float32)
    return np.clip(maps, 0, 1)


def test_coords_matches_cmrtpu():
    """The combiner on a 'model' whose rotated members disagree: per orbit
    member a different blob, so every branch (pass-through, rescue stamp,
    suppression) occurs."""
    rng = np.random.default_rng(7)
    members = {k: _landmark_maps(rng) for k in range(4)}
    members[0][1, ..., 0] *= 0.4          # the identity misses: rescue
    for k in (1, 2, 3):                   # the majority misses: suppress
        members[k][2, ..., 1] *= 0.4
    x = np.zeros((4, 32, 32, 1), np.float32)

    # both combiners call the forward once per orbit member, in order
    calls = {"k": 0}

    def jax_forward(_v, a):
        k = calls["k"] % 4
        calls["k"] += 1
        return jnp.rot90(jnp.asarray(members[k]), k, axes=(-3, -2))

    want = np.asarray(JT.tta_rot90_coords_forward(jax_forward, [32, 32])(
        None, x))
    calls["k"] = 0

    def torch_forward(a):
        k = calls["k"] % 4
        calls["k"] += 1
        return torch.rot90(torch.from_numpy(members[k]), k, (-3, -2))

    got = T.tta_rot90_coords_forward(torch_forward, [32, 32])(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, ..., 0] == 1.0).sum() == 9      # the rescue stamp
    assert got[2, ..., 1].sum() == 0.0             # suppressed
    np.testing.assert_array_equal(got[0], members[0][0])  # passed through


def test_coords_on_a_model_matches_cmrtpu():
    jm, variables, model = _pair(CFG, head_scale=30.0)
    x = _x((4, 32, 32, 1), seed=2)
    fwd = lambda v, a: jm.apply(v, a, train=False)
    want = np.asarray(JT.tta_rot90_coords_forward(fwd, [32, 32])(
        variables, x))
    with torch.no_grad():
        got = T.tta_rot90_coords_forward(model, [32, 32])(
            torch.from_numpy(x)).numpy()
        identity = model(torch.from_numpy(x)).numpy()
    stamped = np.isin(want, (0.0, 1.0)).all(axis=(1, 2))  # [N, C]
    passed = ~stamped
    for n, c in zip(*np.nonzero(passed)):
        np.testing.assert_allclose(got[n, ..., c], want[n, ..., c],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[n, ..., c], identity[n, ..., c],
                                   atol=0, rtol=0)
    # stamps: equal centres unless a mean sits within 1e-3 of a .5 tie
    maps = [np.rot90(np.asarray(fwd(variables, np.rot90(x, k, (-3, -2)))),
                     -k, (-3, -2)) for k in range(4)]
    for n, c in zip(*np.nonzero(stamped)):
        cy = [np.nonzero(m[n, ..., c] > 0.5) for m in maps]
        means = np.array([(a.mean(), b.mean()) for a, b in cy if len(a)])
        near_tie = len(means) and np.any(
            np.abs(np.abs(means.mean(0) - np.floor(means.mean(0))) - 0.5)
            < 1e-3)
        if not near_tie:
            np.testing.assert_array_equal(got[n, ..., c], want[n, ..., c])


def test_coords_rejects_multihead():
    cfg = dict(CFG, TTA_MODE="coords",
               HEADS=[["rvip", 2, "sigmoid"], ["seg", 3, "softmax"]])
    with pytest.raises(ValueError, match="landmark-head"):
        T.tta_forward_from_config(lambda x: x, cfg)
    with pytest.raises(ValueError, match="expected 'probs' or 'coords'"):
        T.tta_forward_from_config(lambda x: x, dict(CFG, TTA_MODE="mean"))


def test_bare_tta_is_probs_in_both_packages(tmp_path):
    """ROADMAP Queue 3: a bare TTA: true keeps cmrtpu's default, 'probs'
    (averaged maps), so one config computes the same function in both
    packages; the port's Predictor with it equals cmrtpu's Predictor and
    the port's explicit 'probs' forward, and differs from 'coords'."""
    jm, variables, model = _pair(CFG, head_scale=30.0)
    jax_ckpt.save_weights(str(tmp_path), variables["params"],
                          variables.get("batch_stats"))
    cfg = dict(CFG, TTA=True)
    x = _x((4, 32, 32, 1), seed=2)
    got = Predictor(cfg, str(tmp_path), device="cpu").predict(x)
    want = JaxPredictor(cfg, str(tmp_path)).predict(x)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    with torch.no_grad():
        probs = T.tta_rot90_forward(model, CFG["DIM"])(
            torch.from_numpy(x)).numpy()
        coords = T.tta_rot90_coords_forward(model, CFG["DIM"])(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, probs, atol=1e-6, rtol=0)
    assert np.abs(got - coords).max() > 1e-2
    # and the explicit coords mode reaches the Predictor
    got_c = Predictor(dict(cfg, TTA_MODE="coords"), str(tmp_path),
                      device="cpu").predict(x)
    np.testing.assert_allclose(got_c, coords, atol=1e-6, rtol=0)


def test_predict_tta_twin_is_an_override_twin(monkeypatch):
    from cmrtpu_torch.predict import predictor

    seen = {}
    monkeypatch.setattr(predictor, "predict_override_twin",
                        lambda root, overrides, suffix, device: seen.update(
                            root=root, overrides=overrides, suffix=suffix,
                            device=device) or root + "_" + suffix)
    assert T.predict_tta_twin("exp/ts", "coords", device="cpu") == \
        "exp/ts_tta_coords"
    assert seen == {"root": "exp/ts", "suffix": "tta_coords",
                    "overrides": {"TTA": True, "TTA_MODE": "coords"},
                    "device": "cpu"}
