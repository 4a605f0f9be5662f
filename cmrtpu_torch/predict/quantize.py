"""Post-training int8 quantization (PTQ) for serving — counterpart of
``cmrtpu/predict/quantize.py``.

From a trained float fold, offline:

  1. **Calibrate**: the float model runs over representative batches with
     every ConvBlock in ``quant_mode='calib'``, which keeps the running
     per-input-channel max-abs of the block's input; the maxima over all
     batches are read once at the end.
  2. **Quantize** (numpy, a copy of cmrtpu's arithmetic on the flax tree):
     ``act_scale = amax / 127`` is folded into the kernel along its input
     channels, then the kernel is quantized per output channel (int8
     ``kernel_q``, float32 ``w_scale``). A weight-standardised block's
     kernel is quantized from its effective kernel (the standardisation
     and gain applied), so the twin needs no standardisation pass. Norms,
     up-sampling convs and heads stay float.
  3. **Bias correction** (``bias_correction=True``): each quantized conv's
     mean output error per channel on the calibration batches, upstream
     first, folded into the twin's bias (``bias_correct``).
  4. **Refit GroupNorm** (GROUP_NORM configs): two passes of a per-channel
     least-squares refit of every GroupNorm affine against the float model,
     both forwards on the device and only [C]-vectors of moments to the
     host.

``QUANT_INT8: true`` then builds the twin (``models/unet.py:QuantConv``),
which rides ``pred_fold``, the evaluation, the ``EnsemblePredictor``, the
export and the serving engine unchanged. The conv runs on ``torch._int_mm``
(``ops/int8_conv.py``); FP8 is not used, because it computes another
function than cmrtpu's twin.

Divergences from cmrtpu (ROADMAP Queue 3): a GroupNorm channel whose scale
is below ``GN_SCALE_FLOOR`` is degenerate and keeps its affine, where
cmrtpu divides by it (inf/NaN moments); (2+1)D and hybrid models raise.
``quantize_model`` runs ``bias_correct`` only when asked, as cmrtpu's code
does (its docstring promises it by default for GroupNorm).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.predict.predictor import resolve_device
from cmrtpu_torch.train.checkpoint import (_flatten, _unflatten,
                                           flax_to_state_dict, load_weights,
                                           save_weights)
from cmrtpu_torch.utils.io_utils import ensure_dir

# |GroupNorm scale| below which gn_recalibrate treats a channel as
# degenerate and keeps its affine: the normalized activation is recovered
# as (y - bias) / scale, and float32 y carries ~6e-8 * |y| of rounding, so
# below 1e-4 the recovery error reaches ~1e-3 of the activation and the
# channel's output is its bias to within 1e-4 of its normalized input
GN_SCALE_FLOOR = 1e-4
GN_PASSES = 2


def _scope(module_name: str) -> Tuple[str, ...]:
    return tuple(module_name.split("."))


def _conv_blocks(model: torch.nn.Module):
    """(scope, ConvBlock) of every quant_mode-aware block of a U-Net."""
    from cmrtpu_torch.models.unet import ConvBlock

    return [(_scope(name), mod) for name, mod in model.named_modules()
            if isinstance(mod, ConvBlock)]


def _require_unet(config: Dict) -> None:
    variant = str(C.get(config, "MODEL_VARIANT", "unet") or "unet").lower()
    if variant == "unet_2p1d" or C.get(config, "FACTORIZED_3D", False):
        raise ValueError(
            "int8 PTQ does not support factorized (2+1)D models "
            "(MODEL_VARIANT='unet_2p1d' / FACTORIZED_3D=True): the quantized "
            "twin's ConvBlocks are unfactorized and cannot consume a "
            "factorized checkpoint. Train the plain 3D variant, or serve "
            "the factorized model in float.")
    if variant != "unet":
        raise ValueError(
            f"MODEL_VARIANT={variant!r} has no quant_mode — int8 PTQ covers "
            "the UNet family (plain MODEL_VARIANT)")


def _float_model(config: Dict, variables: Dict, device: torch.device):
    from cmrtpu_torch.models.unet import build_model

    model = build_model(config)
    model.load_state_dict(flax_to_state_dict(
        variables["params"], variables.get("batch_stats") or {}))
    return model.to(device).eval()


@torch.inference_mode()
def calibrate(model: torch.nn.Module, batches: Iterable[np.ndarray]
              ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Per-ConvBlock, per-input-channel max-abs of the block's input over
    ``batches`` (model-ready [N, *DIM, C] float arrays), on the model's
    device: ``{block scope: float64 [C_in]}``."""
    blocks = _conv_blocks(model)
    if not blocks:
        raise ValueError("no ConvBlock to calibrate — is this a U-Net?")
    device = next(model.parameters()).device
    for _, block in blocks:
        block.quant_mode, block.calib_amax = "calib", None
    n = 0
    try:
        for x in batches:
            model(torch.as_tensor(np.asarray(x, np.float32), device=device))
            n += 1
        if not n:
            raise ValueError("calibration needs at least one batch")
        return {scope: block.calib_amax.cpu().numpy().astype(np.float64)
                for scope, block in blocks}
    finally:
        for _, block in blocks:
            block.quant_mode, block.calib_amax = "", None


# the float convs a ConvBlock may hold, as cmrtpu names them
FLOAT_CONVS = ("Conv_0", "WSConv_0")


def _effective_kernel(conv_name: str, subtree: Dict[str, np.ndarray]):
    """(kernel, bias) in float64 as the float conv applies them: a
    ``WSConv_0`` kernel [*k, I, O] standardised over (spatial, in) per
    output channel and scaled by ``gain / sqrt(max(var * fan_in, 1e-4))``,
    cmrtpu's arithmetic in float64; a ``Conv_0`` kernel as it is."""
    kernel = np.asarray(subtree["kernel"], np.float64)
    bias = np.asarray(subtree["bias"], np.float64)
    if conv_name == "WSConv_0":
        gain = np.asarray(subtree["gain"], np.float64)
        axes = tuple(range(kernel.ndim - 1))
        mean = kernel.mean(axis=axes, keepdims=True)
        var = kernel.var(axis=axes, keepdims=True)
        fan_in = float(np.prod(kernel.shape[:-1]))
        kernel = (kernel - mean) * (
            gain / np.sqrt(np.maximum(var * fan_in, 1e-4)))
    elif conv_name != "Conv_0":
        raise ValueError(f"{conv_name}: not one of {FLOAT_CONVS}")
    return kernel, bias


def quantize_variables(variables: Dict,
                       amax: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    """The float variable trees (flax layout, numpy) -> the int8 twin's, a
    copy: every calibrated block's ``Conv_0`` or ``WSConv_0`` becomes
    ``QuantConv_0`` (int8 ``kernel_q``, float32 ``w_scale`` per output
    channel, ``act_scale`` per input channel, ``bias``), quantized from its
    effective kernel with ``act_scale`` folded in; every other leaf passes
    through."""
    flat = {k: np.asarray(v) for k, v in _flatten(variables["params"]).items()}
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    replaced = []
    for scope, a in sorted(amax.items()):
        conv_name = next((name for name in FLOAT_CONVS
                          if scope + (name, "kernel") in flat), None)
        if conv_name is None:
            raise KeyError(f"calibrated block {'/'.join(scope)} has no "
                           "Conv_0/WSConv_0 kernel in the parameter tree")
        subtree = {k[-1]: v for k, v in flat.items()
                   if k[:-1] == scope + (conv_name,)}
        kernel, bias = _effective_kernel(conv_name, subtree)
        act_scale = np.maximum(np.asarray(a, np.float64), 1e-12) / 127.0
        # the kernel is [*spatial, I, O]: act_scale broadcasts over I
        kernel = kernel * act_scale[:, None]
        axes = tuple(range(kernel.ndim - 1))
        w_scale = np.maximum(np.abs(kernel).max(axis=axes), 1e-12) / 127.0
        kernel_q = np.clip(np.rint(kernel / w_scale), -127, 127
                           ).astype(np.int8)
        q = scope + ("QuantConv_0",)
        out[q + ("kernel_q",)] = kernel_q
        out[q + ("w_scale",)] = w_scale.astype(np.float32)
        out[q + ("act_scale",)] = act_scale.astype(np.float32)
        out[q + ("bias",)] = bias.astype(np.float32)
        replaced.append(scope + (conv_name,))
    for key, val in flat.items():
        if not any(key[:len(p)] == p for p in replaced):
            out[key] = val.copy()
    stats = {k: np.asarray(v).copy() for k, v in
             _flatten(variables.get("batch_stats") or {}).items()}
    return {"params": _unflatten(out), "batch_stats": _unflatten(stats)}


def _forward_order(scope: Tuple[str, ...]):
    """cmrtpu's upstream-first order of block scopes: DownBlocks, the
    bottleneck's ConvBlocks, UpBlocks, each by index, their ConvBlocks by
    index."""
    pos = []
    for part in scope:
        kind, _, idx = part.rpartition("_")
        pos.append(({"DownBlock": 0, "ConvBlock": 1, "UpBlock": 2}.get(
            kind, 3), int(idx) if idx.isdigit() else 0))
    return pos


@contextlib.contextmanager
def _conv_channel_means(block, sink: list):
    """Inside the block each call of ``block``'s conv (``ConvBlock._conv``:
    the raw conv output, bias added, before activation and norm) appends
    its float64 mean per output channel, on the device, to ``sink``."""
    conv = block._conv

    def capture(x):
        y = conv(x)
        sink.append(y.double().mean(dim=(0, *range(2, y.dim()))))
        return y

    block._conv = capture
    try:
        yield
    finally:
        del block._conv


@torch.inference_mode()
def bias_correct(model: torch.nn.Module, variables: Dict, qcfg: Dict,
                 qvars: Dict, batches: Iterable[np.ndarray]) -> Dict:
    """Per-output-channel bias correction of the int8 twin (cmrtpu's
    ``bias_correct``; Nagel et al., arXiv:1906.04721 §5, computed
    empirically): the float U-Net ``model`` (``variables`` are loaded into
    it; it runs on its device) and the twin of ``qcfg`` run the same
    ``batches``, and each quantized conv's raw output is captured. The
    twin's convs are visited upstream first (``_forward_order``); each one
    adds E[float_out - quant_out] per output channel, over every batch,
    to its float32 bias, with the twin's upstream biases already
    corrected. Returns the corrected trees (a copy)."""
    from cmrtpu_torch.models.unet import build_model

    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in flax_to_state_dict(
        variables["params"], variables.get("batch_stats") or {}).items()})
    model.eval()
    batches = [torch.as_tensor(np.asarray(b, np.float32), device=device)
               for b in batches]
    float_blocks = dict(_conv_blocks(model))
    float_means = {scope: [] for scope in float_blocks}
    with contextlib.ExitStack() as stack:
        for scope, block in float_blocks.items():
            stack.enter_context(_conv_channel_means(block,
                                                    float_means[scope]))
        for x in batches:
            model(x)
    stats = qvars.get("batch_stats") or {}
    qmodel = build_model(qcfg).to(device).eval()
    qmodel.load_state_dict({k: v.to(device) for k, v in flax_to_state_dict(
        qvars["params"], stats).items()})
    corrected = {k: np.asarray(v).copy() for k, v in
                 _flatten(qvars["params"]).items()}
    q_blocks = dict(_conv_blocks(qmodel))
    for scope in sorted((s for s in q_blocks
                         if s + ("QuantConv_0", "bias") in corrected),
                        key=_forward_order):
        if len(float_means.get(scope, ())) != len(batches):
            raise KeyError(f"bias_correct: no float conv output for "
                           f"{'/'.join(scope)}")
        block, q_means = q_blocks[scope], []
        with _conv_channel_means(block, q_means):
            for x in batches:
                qmodel(x)
        delta = sum((f - q).cpu().numpy() for f, q in
                    zip(float_means[scope], q_means)) / len(batches)
        key = scope + ("QuantConv_0", "bias")
        corrected[key] = (np.asarray(corrected[key], np.float64)
                          + delta).astype(np.float32)
        block.QuantConv_0.bias.copy_(torch.from_numpy(corrected[key]))
    return {"params": _unflatten(corrected), "batch_stats": stats}


def _group_norms(model: torch.nn.Module):
    return [(_scope(name)[:-1], mod) for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.GroupNorm)]


@torch.inference_mode()
def _gn_moments(model: torch.nn.Module, qmodel: torch.nn.Module,
                batches: List[np.ndarray]) -> Dict[Tuple[str, ...], list]:
    """Per GroupNorm scope, the float64 sums over ``batches`` of the
    quantized path's normalized activations n_q, the float model's
    GroupNorm output y_f, n_q * y_f, n_q ** 2 and the count, per channel.
    n_q is recovered from the twin's GroupNorm output as (y_q - bias) /
    scale, with a scale below GN_SCALE_FLOOR read as 1 (the channel is
    degenerate and keeps its affine). Each batch runs the float forward,
    keeping its GroupNorm outputs, then the twin's, whose hooks reduce each
    output against the float one on the device; one [C]-vector per sum
    comes to the host per batch."""
    device = next(model.parameters()).device
    float_out: Dict[Tuple[str, ...], torch.Tensor] = {}
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    counts: Dict[Tuple[str, ...], float] = {}

    def keep(scope):
        def hook(_mod, _inp, out):
            float_out[scope] = out.float()
        return hook

    def reduce(scope):
        def hook(mod, _inp, out):
            y_f = float_out.pop(scope)
            y_q = out.float()
            shape = (-1, *[1] * (y_q.dim() - 2))
            scale = torch.where(mod.weight.abs() < GN_SCALE_FLOOR,
                                torch.ones_like(mod.weight), mod.weight)
            n_q = (y_q - mod.bias.reshape(shape)) / scale.reshape(shape)
            dims = (0, *range(2, y_q.dim()))
            sums[scope] = torch.stack([n_q.sum(dims), y_f.sum(dims),
                                       (n_q * y_f).sum(dims),
                                       (n_q * n_q).sum(dims)])
            counts[scope] = float(y_q.numel() // y_q.shape[1])
        return hook

    if not _group_norms(model):  # e.g. a WS net under GROUP_NORM
        return {}
    handles = [mod.register_forward_hook(keep(scope))
               for scope, mod in _group_norms(model)]
    handles += [mod.register_forward_hook(reduce(scope))
                for scope, mod in _group_norms(qmodel)]
    acc: Dict[Tuple[str, ...], list] = {}
    try:
        for x in batches:
            xt = torch.as_tensor(x, device=device)
            model(xt)
            qmodel(xt)
            scopes = sorted(sums)
            widths = [sums[s].shape[1] for s in scopes]
            host = torch.cat([sums.pop(s) for s in scopes], dim=1)
            parts = np.split(host.cpu().numpy().astype(np.float64),
                             np.cumsum(widths)[:-1], axis=1)
            for scope, vals in zip(scopes, parts):
                prev = acc.get(scope, [0.0] * 5)
                acc[scope] = [prev[i] + vals[i] for i in range(4)] \
                    + [prev[4] + counts[scope]]
    finally:
        for h in handles:
            h.remove()
    return acc


def gn_recalibrate(model: torch.nn.Module, qcfg: Dict, qvars: Dict,
                   batches: Iterable[np.ndarray]) -> Dict:
    """Per-channel least-squares refit of every GroupNorm affine of the
    int8 twin against the float ``model`` (cmrtpu's ``gn_recalibrate``),
    in GN_PASSES rounds of fit-all-scopes-at-once, each round against the
    twin of the round before: scale = cov(n_q, y_f) / var(n_q), bias =
    mean(y_f) - scale * mean(n_q). A channel whose n_q barely varies (var
    <= 1e-8) or whose scale lies below GN_SCALE_FLOOR keeps its affine.
    Returns the refitted trees (a copy)."""
    from cmrtpu_torch.models.unet import build_model

    device = next(model.parameters()).device
    batches = [np.asarray(b, np.float32) for b in batches]
    corrected = {k: np.asarray(v) for k, v in
                 _flatten(qvars["params"]).items()}
    stats = qvars.get("batch_stats") or {}
    qmodel = build_model(qcfg).to(device).eval()
    for _ in range(GN_PASSES):
        qmodel.load_state_dict({k: v.to(device) for k, v in
                                flax_to_state_dict(_unflatten(corrected),
                                                   stats).items()})
        moments = _gn_moments(model, qmodel, batches)
        for scope, (sn, sy, sny, snn, cnt) in moments.items():
            key_s = scope + ("GroupNorm_0", "scale")
            key_b = scope + ("GroupNorm_0", "bias")
            s = np.asarray(corrected[key_s], np.float64)
            b = np.asarray(corrected[key_b], np.float64)
            var = snn / cnt - (sn / cnt) ** 2
            cov = sny / cnt - (sn / cnt) * (sy / cnt)
            ok = (var > 1e-8) & (np.abs(s) >= GN_SCALE_FLOOR)
            alpha = np.where(ok, cov / np.where(ok, var, 1.0), s)
            beta = np.where(ok, sy / cnt - alpha * (sn / cnt), b)
            corrected[key_s] = alpha.astype(np.float32)
            corrected[key_b] = beta.astype(np.float32)
    return {"params": _unflatten(corrected), "batch_stats": stats}


def quantize_model(config: Dict, variables: Dict,
                   calib_batches: Iterable[np.ndarray],
                   bias_correction: bool = None, device="cuda"):
    """Trained float (config, variable trees) -> int8 twin (config with
    ``QUANT_INT8: true``, variable trees): calibrate, correct and refit on
    ``device``, quantize on the host. ``bias_correction`` true runs
    ``bias_correct``; its default, None, does not, as in cmrtpu. GroupNorm
    configs then get ``gn_recalibrate``."""
    cfg = C.normalise_config(config)
    if C.get(cfg, "QUANT_INT8", False):
        raise ValueError("config is already the int8 twin (QUANT_INT8=True) "
                         "— quantize the FLOAT fold/checkpoint instead")
    _require_unet(cfg)
    dev = resolve_device(device)
    model = _float_model(cfg, variables, dev)
    calib = [np.asarray(b, np.float32) for b in calib_batches]
    amax = calibrate(model, calib)
    qvars = quantize_variables(variables, amax)
    qcfg = dict(cfg)
    qcfg["QUANT_INT8"] = True
    if bias_correction:
        qvars = bias_correct(model, variables, qcfg, qvars, calib)
    if int(C.get(cfg, "GROUP_NORM", 0) or 0):
        qvars = gn_recalibrate(model, qcfg, qvars, calib)
    return qcfg, qvars


def quantize_fold(fold_dir: str, calib_paths, out_dir: str = None,
                  batch: int = 8, max_slices: int = 256,
                  device="cuda") -> str:
    """A trained fold's int8 twin as a sibling fold directory, by default
    ``<exp_root>_int8/<fold>`` (one fold family per root): its config with
    ``QUANT_INT8: true`` and the paths re-rooted, and its int8
    ``model/model.npz``, calibrated on ``calib_paths`` (study files,
    ``calibration_batches_from_studies``). ``pred_fold``, the evaluation
    and the serving engine take it as they take the float fold."""
    cfg = C.load_config(os.path.join(fold_dir, "config", "config.json"))
    params, batch_stats = load_weights(os.path.join(fold_dir, "model"))
    batches = calibration_batches_from_studies(
        calib_paths, cfg, batch=batch, max_slices=max_slices)
    qcfg, qvars = quantize_model(
        cfg, {"params": params, "batch_stats": batch_stats}, batches,
        device=device)
    if out_dir is None:
        fold = os.path.abspath(fold_dir.rstrip("/"))
        out_dir = os.path.join(os.path.dirname(fold) + "_int8",
                               os.path.basename(fold))
    qcfg["EXP_PATH"] = out_dir
    qcfg["MODEL_PATH"] = os.path.join(out_dir, "model")
    ensure_dir(os.path.join(out_dir, "config"))
    with open(os.path.join(out_dir, "config", "config.json"), "w") as fh:
        json.dump(qcfg, fh, indent=2, default=str)
    save_weights(qcfg["MODEL_PATH"], flax_to_state_dict(
        qvars["params"], qvars["batch_stats"]))
    return out_dir


def calibration_batches_from_studies(paths, cfg: Dict, batch: int = 8,
                                     max_slices: int = 256):
    """Calibration inputs from study files through the serving engine's
    preprocessing (``preprocess_model_input``): [batch, *DIM, C] float32
    arrays, the last padded by repeating real slices. 2D configs only,
    checked at call time."""
    dim = C.get(C.normalise_config(cfg), "DIM")
    if len(dim) != 2:
        raise ValueError(
            f"study-based calibration is slice-based and needs a 2D config; "
            f"got DIM={list(dim)}. Calibrate 3D/cine models by passing "
            f"in-memory [batch, *DIM, C] arrays to quantize_model directly.")
    return _calibration_batches_2d(paths, cfg, batch, max_slices)


def _calibration_batches_2d(paths, cfg: Dict, batch: int, max_slices: int):
    from cmrtpu_torch.io import read_image
    from cmrtpu_torch.predict.predictor import preprocess_model_input

    slices = []
    for path in paths:
        img = read_image(path)
        nda = img.array
        if nda.ndim == 2:
            nda = nda[None]
        if nda.ndim != 3:
            raise ValueError(f"{path}: calibration expects 2D/3D studies, "
                             f"got shape {nda.shape}")
        slices.append(
            preprocess_model_input(nda, img.spacing[:2], cfg).numpy())
        if sum(s.shape[0] for s in slices) >= max_slices:
            break
    if not slices:
        raise ValueError("no calibration studies found")
    x = np.concatenate(slices)[:max_slices]
    for start in range(0, x.shape[0], batch):
        chunk = x[start:start + batch]
        if chunk.shape[0] < batch:  # repeat real slices, not zeros
            reps = -(-batch // chunk.shape[0])
            chunk = np.concatenate([chunk] * reps)[:batch]
        yield chunk
