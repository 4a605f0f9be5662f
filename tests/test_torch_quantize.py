"""cmrtpu_torch's int8 post-training quantization against cmrtpu's
(``cmrtpu/predict/quantize.py``, ``QuantConv`` in ``cmrtpu/models/unet.py``).

The same numpy weights and inputs go through both packages on the CPU. The
int8 conv and the quantizer are exact (bit-equal); calibration, whose max-abs
reads float32 activations of two different forwards, agrees within rtol
1e-5; a whole twin's probabilities within 1e-3 of cmrtpu's on the same int8
tree (an input that lands within an ulp of a rounding boundary of x /
act_scale flips one int8 step, measured 5.4e-4 at most here), and within
cmrtpu's own gate (<0.05 max, <0.01 mean; ``tests/test_quantize.py``) of the
float model it was made from."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cmrtpu.models.hybrids import get_model as jax_get_model
from cmrtpu.models.unet import QuantConv as JaxQuantConv
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict import quantize as JQ
from cmrtpu.train.trainer import Trainer as JaxTrainer
from cmrtpu_torch.io import MedicalImage, write_image
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import QuantConv, build_model
from cmrtpu_torch.ops.int8_conv import int8_conv, int8_conv_plain
from cmrtpu_torch.predict import quantize as Q
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           load_weights_for_model,
                                           save_weights)
from cmrtpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 8, "MASK_CLASSES": 2,
       "BATCHSIZE": 8, "MIXED_PRECISION": False, "LEARNING_RATE": 1e-3,
       "SEED": 7}
CPU = torch.device("cpu")
# bias_correct's corrected biases against cmrtpu's on one quantized tree:
# measured 2.4e-6 at most on this fixture (two frameworks' float32 conv
# outputs, averaged); 1e-5 keeps 4x over it
BIAS_CORRECT_ATOL = 1e-5


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree)).items()}


@pytest.fixture(scope="module")
def trained():
    """cmrtpu's own fixture of tests/test_quantize.py: the BatchNorm U-Net
    trained 5 epochs by cmrtpu's Trainer; (variables, x, float probs)."""
    rng = np.random.default_rng(0)
    x = rng.random((8, 32, 32, 1)).astype(np.float32)
    y = (rng.random((8, 32, 32, 2)) > 0.95).astype(np.float32)
    trainer = JaxTrainer(CFG)
    trainer.fit([(x, y)], epochs=5)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": trainer.state.params,
        "batch_stats": trainer.state.batch_stats})
    return variables, x, np.asarray(trainer.predict(x))


def _random_variables(cfg, seed):
    return jax.tree_util.tree_map(np.asarray, dict(init_variables(
        jax_build_model(cfg), cfg, jax.random.key(seed,
                                                  impl="threefry2x32"))))


def _twin(qcfg, qvars):
    model = build_model(qcfg)
    model.load_state_dict(flax_to_state_dict(qvars["params"],
                                             qvars["batch_stats"]))
    return model.eval()


@pytest.mark.parametrize("shape,kernel", [
    ((2, 1, 9, 7), (5, 1, 3, 3)),       # K = 9 -> 16, N = 5 -> 8
    ((1, 4, 3, 3), (3, 4, 3, 3)),       # 9 rows -> 24
    ((2, 2, 5, 6), (4, 2, 2, 2)),       # an even window: SAME pads high
    ((1, 3, 4, 6, 5), (10, 3, 3, 3, 3)),
], ids=["first-block", "few-rows", "even-window", "3d"])
def test_int8_conv_equals_its_plain_version(shape, kernel):
    gen = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, kernel, dtype=torch.int8, generator=gen)
    got = int8_conv(q, w)
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_conv_plain(q, w))
    # every operand at +-127: the largest sums stay exact
    full = torch.full(shape, -127, dtype=torch.int8)
    assert torch.equal(int8_conv(full, w.abs()), int8_conv_plain(full,
                                                                 w.abs()))


@pytest.mark.parametrize("f_size", [(3, 3), (3, 3, 3)], ids=["2d", "3d"])
def test_quant_conv_is_bit_equal_to_cmrtpu(f_size):
    """cmrtpu's QuantConv and the port's on cmrtpu's own int8 tree and the
    same inputs: every output bit equal (the quantizer rounds half to even
    on both sides; the int32 sums are exact; the epilogue is one float32
    multiply and one add)."""
    rng = np.random.default_rng(1)
    shape = (2, 9, 11, 5) if len(f_size) == 2 else (1, 4, 6, 7, 3)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    # ties of x / act_scale at .5, which the two roundings must agree on
    act = (rng.random(shape[-1]) * 0.05 + 1e-2).astype(np.float32)
    x.reshape(-1, shape[-1])[:7] = (np.arange(7)[:, None] + 0.5) * act
    tree = {"kernel_q": rng.integers(-127, 128, (*f_size, shape[-1], 6)
                                     ).astype(np.int8),
            "w_scale": (rng.random(6) * 0.01 + 1e-3).astype(np.float32),
            "act_scale": act,
            "bias": rng.normal(size=6).astype(np.float32)}
    want = np.asarray(JaxQuantConv(6, f_size, dtype=jnp.float32).apply(
        {"params": tree}, x))
    conv = QuantConv(shape[-1], 6, f_size, dtype=torch.float32)
    conv.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          flax_to_state_dict({"QuantConv_0": tree}).items()})
    got = conv(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).numpy()
    np.testing.assert_array_equal(got, want)


def test_calibrate_amax_matches_cmrtpu(trained):
    variables, x, _ = trained
    want = JQ.calibrate(jax_get_model(CFG), variables, [x, 0.5 * x, 2 * x])
    got = Q.calibrate(Q._float_model(CFG, variables, CPU),
                      [x, 0.5 * x, 2 * x])
    assert sorted(got) == sorted(want)
    for scope in want:
        assert got[scope].dtype == np.float64
        np.testing.assert_allclose(got[scope], want[scope], rtol=1e-5,
                                   atol=0, err_msg=str(scope))
    with pytest.raises(ValueError, match="at least one batch"):
        Q.calibrate(Q._float_model(CFG, variables, CPU), [])


def test_quantize_variables_is_bit_equal_given_cmrtpus_amax(trained):
    variables, x, _ = trained
    model = jax_get_model(CFG)
    amax = JQ.calibrate(model, variables, [x])
    want = _flat(JQ.quantize_variables(model, variables, amax)["params"])
    got = _flat(Q.quantize_variables(variables, amax)["params"])
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    # the float tree is left as it was
    assert ("DownBlock_0", "ConvBlock_0", "Conv_0", "kernel") in \
        _flat(variables["params"])


def test_twin_matches_cmrtpu_and_tracks_the_float_model(trained):
    variables, x, live = trained
    qcfg, qvars = JQ.quantize_model(CFG, variables, [x])
    want = np.asarray(jax_get_model(qcfg).apply(qvars, x, train=False))
    with torch.no_grad():
        same_tree = _twin(qcfg, jax.tree_util.tree_map(np.asarray, qvars))(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(same_tree, want, atol=1e-3, rtol=0)

    pcfg, pvars = Q.quantize_model(CFG, variables, [x], device="cpu")
    assert pcfg["QUANT_INT8"] is True
    with torch.no_grad():
        twin = _twin(pcfg, pvars)(torch.from_numpy(x)).numpy()
    diff = np.abs(twin - live)
    assert diff.max() < 0.05, diff.max()
    assert diff.mean() < 0.01, diff.mean()
    flat = _flat(pvars["params"])
    kq = {k: v for k, v in flat.items() if k[-1] == "kernel_q"}
    assert len(kq) == 10 and all(v.dtype == np.int8 for v in kq.values())
    assert flat[("head", "kernel")].dtype == np.float32
    # BatchNorm affines and statistics pass through unchanged
    bn = [k for k in _flat(variables["params"]) if "BatchNorm_0" in k]
    assert bn and all(np.array_equal(flat[k], _flat(variables["params"])[k])
                      for k in bn)


def test_twin_3d_matches_cmrtpu():
    """The rank-3 QuantConv path: a 3D twin on cmrtpu's tree."""
    cfg = dict(CFG, DIM=[4, 16, 16], M_POOL=[1, 2, 2], F_SIZE=[3, 3, 3],
               DEPTH=2, FILTERS=4, GROUP_NORM=2)
    variables = _random_variables(cfg, 4)
    x = np.random.default_rng(4).random((1, 4, 16, 16, 1)).astype(np.float32)
    model = jax_get_model(cfg)
    qvars = jax.tree_util.tree_map(np.asarray, JQ.quantize_variables(
        model, variables, JQ.calibrate(model, variables, [x])))
    qcfg = dict(cfg, QUANT_INT8=True)
    want = np.asarray(jax_get_model(qcfg).apply(qvars, x, train=False))
    with torch.no_grad():
        got = _twin(qcfg, qvars)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_gn_recalibrate_floors_a_vanishing_scale():
    """ROADMAP Queue 3: cmrtpu divides by the pass-1 GroupNorm scale with
    no floor (quantize.py:320), so a zero scale gives NaN moments for its
    channel (which then keeps its affine only because NaN > 1e-8 is
    false). The port reads a scale below GN_SCALE_FLOOR as degenerate: its
    moments stay finite and the channel keeps its affine. Every other
    channel is refitted as cmrtpu refits it, as far as the two packages'
    float32 moment sums, summed in other orders, allow: the refit divides
    differences of those sums (E[n^2] - E[n]^2), which a nearly constant
    channel makes tiny, so the affines agree within 2e-2 of their block's
    largest |scale| (measured 0.86% at most here). This random-init
    GroupNorm net of 2 channels a group is chaotic enough that those
    differences move its output by up to 0.1, so the twins' outputs are
    not compared."""
    cfg = dict(CFG, GROUP_NORM=4)
    variables = _random_variables(cfg, 3)
    x = (np.random.default_rng(3).normal(size=(8, 32, 32, 1)) * 2).astype(
        np.float32)
    model = jax_get_model(cfg)
    qvars = jax.tree_util.tree_map(np.asarray, JQ.quantize_variables(
        model, variables, JQ.calibrate(model, variables, [x])))
    scope = ("DownBlock_1", "ConvBlock_0")
    gn = qvars["params"][scope[0]][scope[1]]["GroupNorm_0"]
    gn["scale"] = gn["scale"].copy()
    gn["scale"][3] = 0.0
    qcfg = dict(cfg, QUANT_INT8=True)

    float_model = Q._float_model(cfg, variables, CPU)
    moments = Q._gn_moments(float_model, _twin(qcfg, qvars), [x])
    assert all(np.isfinite(m).all() for vals in moments.values()
               for m in vals)
    # cmrtpu's recovery of the normalized activations there: 0 / 0
    _, aux = jax_get_model(qcfg).apply(
        qvars, x, train=False, capture_intermediates=lambda m, _: type(
            m).__name__ == "GroupNorm")
    y_q = np.asarray(aux["intermediates"][scope[0]][scope[1]][
        "GroupNorm_0"]["__call__"][0])
    with np.errstate(invalid="ignore", divide="ignore"):
        n_q = (y_q - gn["bias"]) / gn["scale"]
    assert np.isnan(n_q[..., 3]).all() and np.isfinite(
        np.delete(n_q, 3, axis=-1)).all()

    want = JQ.gn_recalibrate(model, variables, qcfg, qvars, [x])
    got = Q.gn_recalibrate(float_model, qcfg, qvars, [x])
    fw, fg = _flat(want["params"]), _flat(got["params"])
    for leaf in ("scale", "bias"):
        key = scope + ("GroupNorm_0", leaf)
        assert fg[key][3] == fw[key][3] == gn[leaf][3]
    assert sorted(fw) == sorted(fg)
    for key in fw:
        if key[-2] != "GroupNorm_0":
            np.testing.assert_array_equal(fg[key], fw[key])
            continue
        tol = 2e-2 * np.abs(fw[key[:-1] + ("scale",)]).max()
        np.testing.assert_allclose(fg[key], fw[key], atol=tol, rtol=0,
                                   err_msg=str(key))


def test_gn_twin_tracks_the_float_model():
    """quantize_model refits a GroupNorm twin (as cmrtpu's, under the
    GroupNorm gate of tests/test_quantize.py: < 0.35)."""
    cfg = dict(CFG, GROUP_NORM=4)
    variables = _random_variables(cfg, 5)
    x = np.random.default_rng(5).random((8, 32, 32, 1)).astype(np.float32)
    qcfg, qvars = Q.quantize_model(cfg, variables, [x], device="cpu")
    with torch.no_grad():
        live = Q._float_model(cfg, variables, CPU)(torch.from_numpy(x))
        twin = _twin(qcfg, qvars)(torch.from_numpy(x))
    assert torch.isfinite(twin).all()
    assert (twin - live).abs().max() < 0.35


def test_bias_correction_is_on_the_skip_list(trained):
    """``bias_correct`` against cmrtpu's on the same float fold (cmrtpu's
    BatchNorm fixture, f32), the same quantized tree and the same three
    calibration batches: every corrected bias within BIAS_CORRECT_ATOL
    (the float32 conv outputs of two frameworks, and an int8 step that
    flips where x / act_scale lies within an ulp of a rounding boundary).
    ``quantize_model(bias_correction=True)`` runs it, and its default
    does not."""
    variables, x, _ = trained
    batches = [x, 0.5 * x, x[::-1] * 1.5]
    model = jax_get_model(CFG)
    qvars = jax.tree_util.tree_map(np.asarray, JQ.quantize_variables(
        model, variables, JQ.calibrate(model, variables, batches)))
    qcfg = dict(CFG, QUANT_INT8=True)
    want = _flat(JQ.bias_correct(model, variables, qcfg, qvars,
                                 batches)["params"])
    got = _flat(Q.bias_correct(Q._float_model(CFG, variables, CPU),
                               variables, qcfg, qvars, batches)["params"])
    before = _flat(qvars["params"])
    assert sorted(got) == sorted(want)
    biases = [k for k in want if k[-2:] == ("QuantConv_0", "bias")]
    assert len(biases) == 10
    for key in want:
        tol = BIAS_CORRECT_ATOL if key in biases else 0
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=str(key))
    moved = max(np.abs(want[k] - before[k]).max() for k in biases)
    assert moved > 100 * BIAS_CORRECT_ATOL  # the correction is held

    # quantize_model: the port's own calibration, then bias_correct on
    # its own tree when asked, and no correction by default
    plain = Q.quantize_model(CFG, variables, batches, device="cpu")[1]
    corrected = Q.quantize_model(CFG, variables, batches,
                                 bias_correction=True, device="cpu")[1]
    again = _flat(Q.bias_correct(Q._float_model(CFG, variables, CPU),
                                 variables, qcfg, plain, batches)["params"])
    for key in biases:
        np.testing.assert_array_equal(_flat(corrected["params"])[key],
                                      again[key])
        assert not np.array_equal(again[key], _flat(plain["params"])[key])


WS_CFG = dict(CFG, WEIGHT_STANDARDISATION=True, WS_I_UNDERSTAND=True)


@pytest.mark.parametrize("dim", [[32, 32], [4, 16, 16]], ids=["2d", "3d"])
def test_ws_effective_kernel_matches_cmrtpu(dim):
    """The int8 twin of a WS fold: every block's effective kernel and bias
    against cmrtpu's ``_effective_kernel`` leaf by leaf (float64, the same
    arithmetic: rtol 1e-12), then the quantized tree bit-equal given
    cmrtpu's amax, and the twin's forward within 1e-3 of cmrtpu's on that
    tree."""
    cfg = dict(WS_CFG, DIM=dim, F_SIZE=[3] * len(dim),
               M_POOL=[1, 2, 2] if len(dim) == 3 else [2, 2])
    variables = _random_variables(cfg, 9)
    flat = _flat(variables["params"])
    scopes = sorted({k[:-2] for k in flat if k[-2] == "WSConv_0"})
    assert len(scopes) == 10
    for scope in scopes:
        subtree = {k[-1]: v for k, v in flat.items()
                   if k[:-1] == scope + ("WSConv_0",)}
        subtree["gain"] = subtree["gain"] * np.linspace(0.5, 1.5, len(
            subtree["gain"]))
        for a, b in zip(Q._effective_kernel("WSConv_0", subtree),
                        JQ._effective_kernel("WSConv_0", subtree)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0,
                                       err_msg=str(scope))
    x = np.random.default_rng(9).random((2, *dim, 1)).astype(np.float32)
    model = jax_get_model(cfg)
    amax = JQ.calibrate(model, variables, [x])
    want = jax.tree_util.tree_map(np.asarray, JQ.quantize_variables(
        model, variables, amax))
    got = Q.quantize_variables(variables, amax)
    wf, gf = _flat(want["params"]), _flat(got["params"])
    assert sorted(gf) == sorted(wf)
    for key in wf:
        np.testing.assert_array_equal(gf[key], wf[key], err_msg=str(key))
    qcfg = dict(cfg, QUANT_INT8=True)
    ref = np.asarray(jax_get_model(qcfg).apply(want, x, train=False))
    with torch.no_grad():
        twin = _twin(qcfg, want)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(twin, ref, atol=1e-3, rtol=0)


def test_ws_fold_quantizes_and_tracks_the_float_model():
    """quantize_model on a WS tree at a random init (calibration through
    WSConv_0): the port's twin lies from the float model within 1e-3 of
    the distance of cmrtpu's twin from it (max and mean), and within
    cmrtpu's mean gate (< 0.01). GROUP_NORM is set, as in the flagship
    template: a WS net has no GroupNorm, so there is nothing to refit."""
    cfg = dict(WS_CFG, GROUP_NORM=4)
    variables = _random_variables(cfg, 10)
    x = np.random.default_rng(10).random((8, 32, 32, 1)).astype(np.float32)
    live = np.asarray(jax_get_model(cfg).apply(variables, x, train=False))
    jcfg, jvars = JQ.quantize_model(cfg, variables, [x])
    ref = np.abs(np.asarray(jax_get_model(jcfg).apply(jvars, x, train=False))
                 - live)
    qcfg, qvars = Q.quantize_model(cfg, variables, [x], device="cpu")
    with torch.no_grad():
        diff = np.abs(_twin(qcfg, qvars)(torch.from_numpy(x)).numpy()
                      - live)
    assert diff.max() <= ref.max() + 1e-3, (diff.max(), ref.max())
    assert diff.mean() <= ref.mean() + 1e-3 and diff.mean() < 0.01


@pytest.mark.parametrize("extra,match", [
    ({"MODEL_VARIANT": "unet_2p1d"}, "does not support factorized"),
    ({"FACTORIZED_3D": True}, "does not support factorized"),
    ({"MODEL_VARIANT": "wrapper"}, "UNet family"),
], ids=["unet_2p1d", "factorized", "hybrid"])
def test_unsupported_models_raise(extra, match):
    cfg = dict(CFG, DIM=[4, 32, 32], F_SIZE=[3, 3, 3], M_POOL=[1, 2, 2],
               **extra)
    with pytest.raises(ValueError, match=match):
        Q.quantize_model(cfg, {"params": {}, "batch_stats": {}},
                         [np.zeros((1, 4, 32, 32, 1), np.float32)],
                         device="cpu")
    with pytest.raises(ValueError, match=match):
        get_model(dict(cfg, QUANT_INT8=True))


def test_double_quantize_and_training_the_twin_refused(trained):
    variables, x, _ = trained
    with pytest.raises(ValueError, match="already the int8 twin"):
        Q.quantize_model(dict(CFG, QUANT_INT8=True), variables, [x],
                         device="cpu")
    with pytest.raises(ValueError, match="serving-only"):
        Trainer(dict(CFG, QUANT_INT8=True), device="cpu")


def test_quantize_on_cuda_without_cuda_raises(trained):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    variables, x, _ = trained
    with pytest.raises(RuntimeError, match="cuda"):
        Q.quantize_model(CFG, variables, [x])


def test_calibration_batches_from_studies(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"study{i}.nrrd")
        write_image(MedicalImage(array=rng.random((3, 40, 40)).astype(
            np.float32) * 500, spacing=(1.2, 1.2, 8.0)), p)
        paths.append(p)
    cfg = dict(CFG, BATCHSIZE=4)
    got = list(Q.calibration_batches_from_studies(paths, cfg, batch=4))
    want = list(JQ.calibration_batches_from_studies(paths, cfg, batch=4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (4, 32, 32, 1) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-6)
    with pytest.raises(ValueError, match="2D config"):
        Q.calibration_batches_from_studies(
            ["unused.nrrd"], dict(CFG, DIM=[4, 32, 32], F_SIZE=[3, 3, 3]))


def test_quantize_fold_writes_a_sibling_twin_that_serves(trained, tmp_path):
    """quantize_fold mirrors the fold into <exp_root>_int8/<fold>; the
    twin's config and int8 model.npz restore through the Predictor and the
    fold's weights load into cmrtpu's twin to the same probabilities."""
    variables, x, _ = trained
    cfg = dict(CFG, SPACING=[1.0, 1.0], RESAMPLE=True, SCALER="MinMax")
    fold = tmp_path / "exp" / "run" / "ts" / "f0"
    (fold / "config").mkdir(parents=True)
    (fold / "config" / "config.json").write_text(json.dumps(cfg))
    save_weights(str(fold / "model"), flax_to_state_dict(
        variables["params"], variables["batch_stats"]))
    study = str(tmp_path / "calib.nrrd")
    write_image(MedicalImage(array=np.random.default_rng(0).normal(
        size=(3, 24, 28)).astype(np.float32), spacing=(1.5, 1.5, 8.0)),
        study)
    twin = Q.quantize_fold(str(fold), [study], device="cpu")
    assert twin == os.path.join(str(tmp_path / "exp" / "run" / "ts_int8"),
                                "f0")
    with open(os.path.join(twin, "config", "config.json")) as fh:
        qcfg = json.load(fh)
    assert qcfg["QUANT_INT8"] is True
    assert qcfg["MODEL_PATH"] == os.path.join(twin, "model")
    got = Predictor(qcfg, device="cpu").predict(x)
    from cmrtpu.train import checkpoint as jax_ckpt
    params, stats = jax_ckpt.load_weights(qcfg["MODEL_PATH"])
    want = np.asarray(jax_get_model(qcfg).apply(
        {"params": params, "batch_stats": stats}, x, train=False))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    model = load_weights_for_model(qcfg["MODEL_PATH"], build_model(qcfg),
                                   qcfg)
    assert model.DownBlock_0.ConvBlock_0.QuantConv_0.kernel_q.dtype \
        == torch.int8
