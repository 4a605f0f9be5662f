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
     ``kernel_q``, float32 ``w_scale``). Norms, up-sampling convs and heads
     stay float.
  3. **Refit GroupNorm** (GROUP_NORM configs): two passes of a per-channel
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
cmrtpu divides by it (inf/NaN moments); ``bias_correct`` is on the skip
list, so ``quantize_model(bias_correction=True)`` raises (its default, off,
is what cmrtpu's code runs); (2+1)D and hybrid models raise.
"""

from __future__ import annotations

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


def _effective_kernel(conv_name: str, subtree: Dict[str, np.ndarray]):
    """(kernel, bias) in float64 as the float conv applies them. Only the
    plain ``Conv_0``: weight standardisation (``WSConv_0``) is on the skip
    list and raises when its model is built."""
    if conv_name != "Conv_0":
        raise ValueError(f"{conv_name}: only the plain Conv_0 is quantized "
                         "(WEIGHT_STANDARDISATION is on the ROADMAP skip "
                         "list)")
    return (np.asarray(subtree["kernel"], np.float64),
            np.asarray(subtree["bias"], np.float64))


def quantize_variables(variables: Dict,
                       amax: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    """The float variable trees (flax layout, numpy) -> the int8 twin's, a
    copy: every calibrated block's ``Conv_0`` becomes ``QuantConv_0``
    (int8 ``kernel_q``, float32 ``w_scale`` per output channel,
    ``act_scale`` per input channel, ``bias``), with ``act_scale`` folded
    into the kernel before it is quantized; every other leaf passes
    through."""
    flat = {k: np.asarray(v) for k, v in _flatten(variables["params"]).items()}
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    replaced = []
    for scope, a in sorted(amax.items()):
        if scope + ("Conv_0", "kernel") not in flat:
            raise KeyError(f"calibrated block {'/'.join(scope)} has no "
                           "Conv_0 kernel in the parameter tree")
        subtree = {k[-1]: v for k, v in flat.items()
                   if k[:-1] == scope + ("Conv_0",)}
        kernel, bias = _effective_kernel("Conv_0", subtree)
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
        replaced.append(scope + ("Conv_0",))
    for key, val in flat.items():
        if not any(key[:len(p)] == p for p in replaced):
            out[key] = val.copy()
    stats = {k: np.asarray(v).copy() for k, v in
             _flatten(variables.get("batch_stats") or {}).items()}
    return {"params": _unflatten(out), "batch_stats": _unflatten(stats)}


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
                   bias_correction: bool = False, device="cuda"):
    """Trained float (config, variable trees) -> int8 twin (config with
    ``QUANT_INT8: true``, variable trees): calibrate and refit on
    ``device``, quantize on the host. GroupNorm configs get
    ``gn_recalibrate``. ``bias_correction`` is on the ROADMAP skip list and
    raises; off is what cmrtpu's code runs by default."""
    cfg = C.normalise_config(config)
    if C.get(cfg, "QUANT_INT8", False):
        raise ValueError("config is already the int8 twin (QUANT_INT8=True) "
                         "— quantize the FLOAT fold/checkpoint instead")
    if bias_correction:
        raise ValueError(
            "bias_correct is on the ROADMAP skip list (measured ineffective, "
            "no production caller): quantize with bias_correction=False; "
            "GroupNorm twins are refitted by gn_recalibrate")
    _require_unet(cfg)
    dev = resolve_device(device)
    model = _float_model(cfg, variables, dev)
    calib = [np.asarray(b, np.float32) for b in calib_batches]
    amax = calibrate(model, calib)
    qvars = quantize_variables(variables, amax)
    qcfg = dict(cfg)
    qcfg["QUANT_INT8"] = True
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
        slices.append(preprocess_model_input(nda, img.spacing[:2], cfg))
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
