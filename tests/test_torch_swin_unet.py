"""MODEL_VARIANT 'swin_unet' (``cmrtpu_torch/models/swin_unet.py``) against
the plain float32 Swin-Unet of ``tests/plain_swin_unet.py`` on seeded
weights, on the CPU at a small size: DIM [64, 64], embed 12, window 4, so
that the 16² and 8² stages shift their windows and the 4² and 2² stages
clamp theirs to the whole side. The forward, the train step with drop
path and Adam, the shift mask, the window partition, bfloat16, serving
through ``ServingEngine.process_study``, the ``model.npz`` round trip and
the dispatch."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.models import swin_unet as S
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import model_summary
from cmrtpu_torch.ops.connected_components import clean_prediction_2d_cc
from cmrtpu_torch.ops.resample import NEAREST
from cmrtpu_torch.predict.postprocess import undo_generator_steps
from cmrtpu_torch.predict.predictor import (preprocess_model_input,
                                            threshold_and_flatten)
from cmrtpu_torch.predict.serving import ServingEngine
from cmrtpu_torch.train import checkpoint as ckpt
from cmrtpu_torch.train.trainer import Trainer
from cmrtpu_torch.utils.profiling import GLOBAL_TIMER

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_swin_unet as P  # noqa: E402

torch.set_num_threads(1)

CFG = {"MODEL_VARIANT": "swin_unet", "DIM": [64, 64], "SWIN_EMBED_DIM": 12,
       "SWIN_WINDOW": 4, "SWIN_HEADS": [2, 2, 4, 4], "IMG_CHANNELS": 1,
       "MASK_CLASSES": 2, "MASK_VALUES": [1, 2], "MIXED_PRECISION": False,
       "DROP_PATH_RATE": 0.3, "BATCHSIZE": 4, "SEED": 5,
       "OPTIMIZER": "adam", "LEARNING_RATE": 1e-3,
       "LOSS_FUNCTION": "BcdDiceLoss", "SPACING": [1.0, 1.0],
       "RESAMPLE": True, "SCALER": "MinMax", "CC_FILTER": True}
# the windows one 64² image attends: 16 + 4 + 1 + 1 in the encoder and
# 1 + 4 + 16 in the decoder, two blocks each
WINDOWS_PER_IMAGE = 2 * (16 + 4 + 1 + 1 + 1 + 4 + 16)
# float32 program against float32 reference: the same operations in
# another order of reshapes and sums, so rounding only
F32_RTOL = 1e-5
# bfloat16 linears and attention products through 14 blocks read about
# 0.01 on the worst row's logits; a forward whose linears, convolution and
# q, k, v are rounded to float8 e4m3 reads 0.11-0.13
BF16_ROW_GAP = 0.03


def _model(cfg=CFG, seed=0):
    return get_model(cfg).reset_parameters(
        torch.Generator().manual_seed(seed))


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _x(n=4, seed=1):
    return torch.randn(n, 64, 64, 1, generator=torch.Generator().manual_seed(
        seed))


def _row_gap(a, b):
    a, b = a.flatten(1).double(), b.flatten(1).double()
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def _logits(model, x, **kw):
    got = {}
    handle = model.output.register_forward_hook(
        lambda m, a, out: got.__setitem__("l", out.movedim(1, -1)))
    try:
        probs = model(x, **kw)
    finally:
        handle.remove()
    return got["l"], probs


def test_stages_shift_and_clamp_as_configured():
    s = C.swin_settings(CFG)
    assert s["stages"] == [(16, 16, 4), (8, 8, 4), (4, 4, 4), (2, 2, 2)]
    model = _model()
    shifts = [b.shift for layer in model.layers for b in layer.blocks]
    assert shifts == [0, 2, 0, 2, 0, 0, 0, 0]
    assert model.layers[3].blocks[0].attn.relative_position_bias_table \
        .shape == (9, 4)


def test_float32_forward_matches_the_plain_reference():
    model = _model().eval()
    x = _x()
    with torch.no_grad():
        logits, probs = _logits(model, x)
        ref = P.Forward(CFG)(_params(model), x, train=False, logits=True)
    assert probs.shape == (4, 64, 64, 2) and probs.dtype == torch.float32
    torch.testing.assert_close(logits, ref, rtol=F32_RTOL, atol=F32_RTOL)
    torch.testing.assert_close(probs, torch.sigmoid(ref), rtol=F32_RTOL,
                               atol=F32_RTOL)


def test_drop_path_masks_replay_from_the_generator():
    """Train mode draws each branch's [N] mask from the generator passed to
    forward, in forward order; the reference draws the same masks."""
    model = _model().train()
    x = _x()
    with torch.no_grad():
        got = model(x, generator=torch.Generator().manual_seed(9))
        again = model(x, generator=torch.Generator().manual_seed(9))
        other = model(x, generator=torch.Generator().manual_seed(10))
        ref = P.Forward(CFG)(_params(model), x, train=True,
                             generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, again, rtol=0, atol=0)
    torch.testing.assert_close(got, ref, rtol=F32_RTOL, atol=F32_RTOL)
    assert (got - other).abs().max() > 1e-3
    with pytest.raises(ValueError, match="generator"):
        model(x)


def test_first_gradient_and_three_adam_steps_match_the_reference():
    """Three ``TrainState.train_step`` calls with drop path on (rate 0.3)
    against the reference's loss, backward and optax's Adam on the same
    rows and drop-path draws (SEED)."""
    model = _model(seed=3)
    weights = _params(model)
    trainer = Trainer(CFG, model=model, device="cpu")
    g = torch.Generator().manual_seed(21)
    batches = [(torch.randn(4, 64, 64, 1, generator=g),
                torch.rand(4, 64, 64, 2, generator=g).round())
               for _ in range(3)]
    first = None
    for x, y in batches:
        trainer.state.train_step(x, y)
        if first is None:
            first = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}

    fwd = P.Forward(CFG)
    params = {k: v.clone() for k, v in weights.items()}
    opt = P.Adam(params, CFG["LEARNING_RATE"])
    drop = torch.Generator().manual_seed(CFG["SEED"])
    for step, (x, y) in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = P.bce_dice_loss(y, fwd(leaves, x, generator=drop))
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        for v in params.values():
            v.requires_grad_(False)
        if step == 0:
            for name, g_ref in grads.items():
                # float32 rounding of the same sums, relative to the leaf
                torch.testing.assert_close(
                    first[name], g_ref, rtol=1e-4,
                    atol=1e-4 * float(g_ref.abs().max()) + 1e-12)
        opt.step(params, grads)
    for name, p in model.named_parameters():
        change, ref_change = p.detach() - weights[name], \
            params[name] - weights[name]
        # Adam's step is about lr where a gradient is far from 0; near 0
        # its sign rounds either way, so the change is held to 1% of the
        # largest step of the leaf
        torch.testing.assert_close(
            change, ref_change, rtol=1e-2,
            atol=1e-2 * float(ref_change.abs().max()) + 1e-9)


@pytest.mark.parametrize("h,w,m,s", [(16, 16, 4, 2), (8, 8, 4, 2),
                                     (14, 14, 7, 3), (12, 8, 4, 1)])
def test_shift_mask_matches_region_ids_pixel_by_pixel(h, w, m, s):
    """The mask against one built pixel by pixel: a token's region on each
    axis is 0 before side - m, 1 before side - s, 2 after."""
    def region(v, side):
        return 0 if v < side - m else (1 if v < side - s else 2)

    mask = S.shift_mask(h, w, m, s)
    n_w = w // m
    assert mask.shape == ((h // m) * n_w, m * m, m * m)
    for k in range(mask.shape[0]):
        r0, c0 = (k // n_w) * m, (k % n_w) * m
        ids = [3 * region(r0 + t // m, h) + region(c0 + t % m, w)
               for t in range(m * m)]
        want = torch.tensor([[0.0 if a == b else S.MASK_VALUE for b in ids]
                             for a in ids])
        torch.testing.assert_close(mask[k], want, rtol=0, atol=0)


def test_window_partition_and_reverse_round_trip():
    x = torch.randn(2, 12, 8, 5)
    win = S.window_partition(x, 4)
    assert win.shape == (2 * 3 * 2, 16, 5)
    # window 3 is image 0's second row of windows, first column
    torch.testing.assert_close(win[2].reshape(4, 4, 5), x[0, 4:8, 0:4],
                               rtol=0, atol=0)
    torch.testing.assert_close(S.window_reverse(win, 4, 12, 8), x, rtol=0,
                               atol=0)


def test_relative_position_index_is_the_public_codes():
    idx = S.relative_position_index(3)
    # tokens (0, 0) and (2, 1): dr = -2, dc = -1 -> (0)(5) + 1
    assert int(idx[0, 7]) == 1
    assert int(idx[7, 0]) == (2 + 2) * 5 + (1 + 2)
    assert int(idx.max()) == 24 and int(idx.min()) == 0


def test_bfloat16_forward_is_inside_a_bound_that_float8_breaks():
    cfg = dict(CFG, MIXED_PRECISION=True)
    model = _model(cfg, seed=2).eval()
    assert model.dtype == torch.bfloat16
    x = _x(seed=4)
    p = _params(model)

    def fp8(t):
        scale = 448.0 / t.abs().amax().clamp(min=1e-30)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    with torch.no_grad():
        logits, probs = _logits(model, x)
        ref = P.Forward(cfg)(p, x, train=False, logits=True)
        low = P.Forward(cfg, rnd=fp8)(p, x, train=False, logits=True)
    assert probs.dtype == torch.float32
    assert _row_gap(logits, ref) < BF16_ROW_GAP
    assert _row_gap(low, ref) > BF16_ROW_GAP


def test_attention_span_and_window_counter():
    model = _model().eval()
    before = GLOBAL_TIMER.counts().get("swin.windows", 0)
    spans = GLOBAL_TIMER.summary().get("swin.attention", {}).get("count", 0)
    with torch.no_grad():
        model(_x(n=3))
    assert GLOBAL_TIMER.counts()["swin.windows"] - before \
        == 3 * WINDOWS_PER_IMAGE
    assert GLOBAL_TIMER.summary()["swin.attention"]["count"] - spans == 14



def _blocks(model):
    return [b for layers in (model.layers, model.layers_up[1:])
            for layer in layers for b in layer.blocks]


def test_pieces_hold_each_parameter_once_and_cut_at_attention():
    """The plan a CUDA graph captures piece by piece: each block's
    attention branch a piece of its own over LN1 and the attention, every
    parameter but the head's in exactly one piece, skips saved by the
    first three encoder stages and taken by the three concatenations, and
    one drop-path draw for each branch with a rate."""
    model = _model()
    plan = model.plan()
    attention = [p for p in plan if p.attention is not None]
    assert len(attention) == 14 and len(plan) == 29
    for piece, b in zip(attention, _blocks(model)):
        assert piece.attention == (b.stage, b.window)
        assert {id(q) for q in piece.parameters()} == {
            id(q) for m in (b.norm1, b.attn) for q in m.parameters()}
    held = [id(q) for piece in plan for q in piece.parameters()]
    assert len(held) == len(set(held))
    assert set(held) == {id(q) for n, q in model.named_parameters()
                         if n != "output.weight"}
    assert sum(p.saves_skip for p in plan) == 3
    assert sum(p.takes_skip for p in plan) == 3
    assert sum(len(p.rates) for p in plan) == 2 * sum(
        b.drop_path > 0 for b in _blocks(model))


def test_capture_samples_each_pieces_inputs(monkeypatch):
    """The capture hands ``make_graphed_callables`` one sample a piece:
    the piece's input and skip carrying gradients (the image not), its
    uniforms not; the graphs are kept for the shape and captured again
    after a parameter is replaced. The CPU has no graphs, so the pieces
    stand in for them here, and their calls run the same forward."""
    got = {}

    def capture(plan, samples):
        got["plan"], got["samples"] = plan, samples
        return plan

    monkeypatch.setattr(torch.cuda, "make_graphed_callables", capture)
    model = _model().train()
    x = torch.movedim(_x(), -1, 1)
    uniforms = model._uniforms(4, torch.Generator().manual_seed(2), "cpu")
    calls = model._graphs(x, uniforms)
    plan, samples = got["plan"], got["samples"]
    assert len(samples) == len(plan) == 29
    assert len(uniforms) == sum(len(p.rates) for p in plan) > 0
    for i, (piece, args) in enumerate(zip(plan, samples)):
        grads = 1 + piece.takes_skip
        assert len(args) == grads + len(piece.rates)
        assert all(a.requires_grad == (i > 0) for a in args[:grads])
        assert not any(a.requires_grad for a in args[grads:])
    assert model._graphs(x, uniforms) is calls
    model.norm.weight = torch.nn.Parameter(model.norm.weight.detach() + 0)
    again = model._graphs(x, uniforms)
    assert again is not calls and got["plan"] is not plan
    with torch.no_grad():
        ref = model._run(model._pieces(), model._pieces(), x, uniforms)
        out = model._run(model._pieces(), again, x, uniforms)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)

def test_a_copy_runs_its_own_modules():
    """A deep copy (an EMA shadow, a twin) rebuilds its plan over its own
    modules; off the card a train step runs the pieces eagerly and keeps
    no graph."""
    model = _model().eval()
    x = _x(n=2)
    with torch.no_grad():
        before = model(x)
        twin = copy.deepcopy(model)
        for q in twin.parameters():
            q.mul_(0.5)
        torch.testing.assert_close(model(x), before, rtol=0, atol=0)
        assert (twin(x) - before).abs().max() > 1e-3
    model.train()
    model(x, generator=torch.Generator().manual_seed(1)).sum().backward()
    assert not model._runtime.get("graphs")

def _study(path, z, seed):
    rng = np.random.default_rng(seed)
    write_image(MedicalImage(array=rng.normal(size=(z, 60, 70)).astype(
        np.float32), spacing=(1.1, 1.1, 8.0), origin=(1.0, 2.0, 3.0)), path)


def test_process_study_serves_the_swin_unet(tmp_path):
    """A fold's ``model.npz`` in the Swin-Unet's own names served by
    ``ServingEngine.process_study``: the written labels are the reference
    forward's on the engine's preprocessed slices, thresholded, filtered
    and undone."""
    model = _model(seed=6)
    with torch.no_grad():  # logits far from 0, so rounding flips no label
        model.output.weight.mul_(50.0)
    ckpt.save_weights(str(tmp_path / "model"), model)
    path = str(tmp_path / "case01.nii.gz")
    _study(path, 5, 0)
    engine = ServingEngine(config=CFG, model_path=str(tmp_path / "model"),
                           device="cpu")
    rec = engine.process_study(path, str(tmp_path / "out"))
    assert rec["slices"] == 5
    got = read_image(str(tmp_path / "out" / "case01_msk_pred.nrrd"))

    img = read_image(path)
    x = preprocess_model_input(img.array, img.spacing[:2], CFG)
    with torch.no_grad():
        probs = P.Forward(CFG)(_params(model), x, train=False).numpy()
    assert np.abs(probs - 0.5).min() > 1e-4
    flat = clean_prediction_2d_cc(threshold_and_flatten(probs)).numpy()
    want = undo_generator_steps(flat.astype(np.uint8), CFG, NEAREST, img)
    assert got.array.shape == img.array.shape
    np.testing.assert_array_equal(got.array, want.array)
    assert got.array.any()


def test_model_npz_round_trip_in_the_models_own_names(tmp_path):
    model = _model(seed=7)
    path = ckpt.save_weights(str(tmp_path / "model"), model)
    with np.load(path) as blobs:
        names = sorted(blobs.files)
    assert names == sorted(ckpt.NATIVE_PREFIX + n
                           for n in model.state_dict())
    restored = ckpt.load_weights_for_model(str(tmp_path / "model"),
                                           _model(seed=8), CFG)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(restored.state_dict()[name], t, rtol=0,
                                   atol=0)
    with pytest.raises(ValueError, match="no cmrtpu layout"):
        ckpt.load_weights(str(tmp_path / "model"))
    # a state_dict (the serving weights a callback writes) takes the same
    # route, and the U-Net keeps its flax layout
    ckpt.save_weights(str(tmp_path / "dict"), dict(model.state_dict()))
    assert not ckpt.has_cmrtpu_layout(model.state_dict())
    unet = get_model({"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4})
    assert ckpt.has_cmrtpu_layout(unet.state_dict())
    summary = model_summary(model)
    total = sum(p.numel() for p in model.parameters())
    assert f"Trainable params: {total}" in summary
    assert "layers.0.blocks.1.attn.qkv.weight" in summary


def test_model_npz_layout_follows_the_bridge(tmp_path):
    """The route is the bridge's, not a model's name: a state_dict of
    which no entry has a flax counterpart keeps its own names, whatever
    the model; one with some such entries is a U-Net's, and a foreign
    entry among them still raises."""
    other = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2))
    assert not ckpt.has_cmrtpu_layout(other.state_dict())
    path = ckpt.save_weights(str(tmp_path / "other"), other)
    with np.load(path) as blobs:
        assert sorted(blobs.files) == sorted(
            ckpt.NATIVE_PREFIX + n for n in other.state_dict())
    unet = get_model({"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4})
    mixed = {**unet.state_dict(), "extra.weight": torch.zeros(2, 3)}
    assert ckpt.has_cmrtpu_layout(mixed)
    with pytest.raises(ValueError, match="no flax counterpart"):
        ckpt.save_weights(str(tmp_path / "mixed"), mixed)


def test_get_model_dispatch_and_what_the_variant_refuses():
    assert isinstance(get_model(CFG), S.SwinUnet)
    assert isinstance(get_model(dict(CFG, MODEL_VARIANT="SWIN_UNET")),
                      S.SwinUnet)
    with pytest.raises(ValueError, match="no int8 twin"):
        get_model(dict(CFG, QUANT_INT8=True))
    with pytest.raises(ValueError, match="HEADS"):
        get_model(dict(CFG, HEADS=[["a", 1, "sigmoid"]]))
    with pytest.raises(ValueError, match="deep-supervision"):
        get_model(CFG, supervision=True)
    with pytest.raises(ValueError, match="not divisible"):
        get_model(dict(CFG, DIM=[60, 64]))
    with pytest.raises(ValueError, match="2D"):
        get_model(dict(CFG, DIM=[8, 64, 64]))
    with pytest.raises(ValueError, match="heads"):
        get_model(dict(CFG, SWIN_HEADS=[5, 2, 4, 4]))
    assert C.parse_override_pairs(["swin_window=7"]) == {"SWIN_WINDOW": 7}


def test_published_widths():
    """The shipped defaults are swin_tiny_patch4_window7_224's: about 27 M
    parameters at 224², 14 blocks."""
    model = get_model({"MODEL_VARIANT": "swin_unet", "DIM": [224, 224],
                       "MASK_CLASSES": 2})
    assert sum(p.numel() for p in model.parameters()) == 27_165_156
    blocks = [b for m in model.modules() if isinstance(m, S.SwinStage)
              for b in m.blocks]
    assert len(blocks) == 14
    assert {b.window for b in blocks} == {7}
    assert [b.shift for b in blocks] == [0, 3] * 3 + [0, 0] + [0, 3] * 3
    assert json.loads(json.dumps(C.SWIN_DEFAULTS))["SWIN_HEADS"] == [3, 6,
                                                                    12, 24]
    # Swin-T's stochastic depth (arXiv:2103.14030, section 4.1)
    assert C.SWIN_DEFAULTS["DROP_PATH_RATE"] == 0.2
