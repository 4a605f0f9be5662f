"""Ahead-of-time export of a fold's forward for serving — counterpart of
``cmrtpu/predict/export.py``.

``export_model`` writes an artifact directory that serves without the
model code:

  * ``forward.pt2`` — a ``torch.export`` program of ``(weights, x) ->
    probabilities`` at a fixed batch (``x_shape``), TTA baked in when the
    fold's config sets it. The weights are an input of the program, not
    constants in it, so
  * ``weights.npz`` (cmrtpu's flat flax keys, ``save_weights``) rides
    beside it: a retrained ``weights.npz`` dropped into the directory
    changes what is served, without a re-export;
  * ``export.json`` — cmrtpu's keys (``x_shape``, ``dim``,
    ``mask_classes``, ``config``) and ``device``, the device type the
    program was traced on.

A program traced on the card names ``cuda`` in its graph (its constants
and its tensor-metadata checks), so ``load_exported`` raises for another
device type instead of moving it quietly (cmrtpu's one StableHLO artifact
serves the CPU and the TPU; ROADMAP Queue 3). A cmrtpu artifact
(``forward.stablehlo``, no ``forward.pt2``) raises and names the export
route.

``fold_batch_norm`` folds frozen BatchNorm into the conv weights of a
BN_FIRST model (numpy, a copy of cmrtpu's arithmetic), and ``int8_calib``
exports the int8 twin (``predict/quantize.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.train.checkpoint import (_flatten, _unflatten,
                                           flax_to_state_dict, load_weights,
                                           save_weights)

ARTIFACT = "forward.pt2"
META = "export.json"
WEIGHTS = "weights.npz"
CMRTPU_ARTIFACT = "forward.stablehlo"

_BN_EPS = 1e-3  # ConvBlock's BatchNorm epsilon (models/unet.py)


def fold_batch_norm(config: Dict, params: Dict, batch_stats: Dict):
    """Fold inference-time BatchNorm into the preceding conv of each block
    (cmrtpu's ``fold_batch_norm``). Valid only for BN_FIRST (conv -> BN ->
    act), where the frozen BN is an affine map of the conv output: ``W' =
    W * s`` per output channel and ``b' = (b - mean) * s + beta`` with ``s
    = gamma / sqrt(var + eps)``, in float64, cast back. Returns
    ``(folded_config, folded_params)``: BATCH_NORMALISATION false, the
    BatchNorm scopes gone."""
    if not C.get(config, "BATCH_NORMALISATION", True):
        raise ValueError("model has no BatchNorm to fold")
    if not C.get(config, "BN_FIRST", False):
        raise ValueError(
            "BN folding requires BN_FIRST (conv->BN->act); the default "
            "conv->act->BN ordering has an activation between conv and BN")
    flat_p = {k: np.asarray(v) for k, v in _flatten(params).items()}
    flat_s = {k: np.asarray(v) for k, v in _flatten(batch_stats).items()}
    out = {k: v.copy() for k, v in flat_p.items() if "BatchNorm_0" not in k}
    for scope in sorted({k[:-2] for k in flat_p if k[-2] == "BatchNorm_0"}):
        gamma = np.asarray(flat_p[scope + ("BatchNorm_0", "scale")],
                           np.float64)
        beta = np.asarray(flat_p[scope + ("BatchNorm_0", "bias")], np.float64)
        mean = np.asarray(flat_s[scope + ("BatchNorm_0", "mean")], np.float64)
        var = np.asarray(flat_s[scope + ("BatchNorm_0", "var")], np.float64)
        s = gamma / np.sqrt(var + _BN_EPS)
        w_key = scope + ("Conv_0", "kernel")
        b_key = scope + ("Conv_0", "bias")
        dtype = out[w_key].dtype
        out[w_key] = (out[w_key].astype(np.float64) * s).astype(dtype)
        out[b_key] = ((out[b_key].astype(np.float64) - mean) * s
                      + beta).astype(dtype)
    folded_cfg = dict(config)
    folded_cfg["BATCH_NORMALISATION"] = False
    return folded_cfg, _unflatten(out)


def _weights(params: Dict, batch_stats: Dict,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """The program's weights input: the state_dict of the flax trees on
    ``device``, its keys sorted, so the exporter and the loader pass the
    same dict whatever wrote the npz."""
    state = flax_to_state_dict(params, batch_stats)
    return {k: state[k].to(device) for k in sorted(state)}


class _Program(torch.nn.Module):
    """(weights, x) -> the model's (or its TTA orbit's) outputs, with the
    weights supplied through ``functional_call``."""

    def __init__(self, model: torch.nn.Module, config: Dict):
        super().__init__()
        self.model = model
        self.config = config

    def forward(self, weights: Dict[str, torch.Tensor], x: torch.Tensor):
        from torch.func import functional_call

        def fn(inp):
            return functional_call(self.model, weights, (inp,))

        if C.get(self.config, "TTA", False):
            from cmrtpu_torch.predict.tta import tta_forward_from_config
            fn = tta_forward_from_config(fn, self.config)
        return fn(x)


def _json_safe(cfg: Dict) -> Dict:
    safe = {}
    for k, v in cfg.items():
        try:
            json.dumps(v)
            safe[k] = v
        except TypeError:
            safe[k] = getattr(v, "__name__", str(v))
    return safe


def export_model(config: Dict, model_path: str, out_dir: str,
                 batch: int = 8, fold_bn: bool = False, int8_calib=None,
                 device="cuda") -> str:
    """Export the restored fold's forward (TTA included) at ``batch`` on
    ``device`` into ``out_dir``: ``forward.pt2``, ``weights.npz`` and
    ``export.json``. ``fold_bn`` folds frozen BatchNorm first (BN_FIRST
    configs); ``int8_calib`` (model-ready calibration batches) exports the
    int8 twin instead of the float model, after the fold if both are
    given."""
    from cmrtpu_torch.models.hybrids import get_model
    from cmrtpu_torch.predict.predictor import _supervised, resolve_device

    dev = resolve_device(device)
    cfg = C.normalise_config(config)
    params, batch_stats = load_weights(model_path)
    if fold_bn:
        cfg, params = fold_batch_norm(cfg, params, batch_stats)
        batch_stats = {}
    if int8_calib is not None:
        from cmrtpu_torch.predict.quantize import quantize_model
        cfg, qvars = quantize_model(
            cfg, {"params": params, "batch_stats": batch_stats}, int8_calib,
            device=dev)
        params, batch_stats = qvars["params"], qvars["batch_stats"]
    # the module's own tensors never run (functional_call supplies them):
    # on the meta device they hold no bytes in forward.pt2
    model = get_model(cfg, supervision=_supervised(model_path)).to(
        "meta").eval()

    dim = tuple(C.get(cfg, "DIM"))
    x_shape = (batch, *dim, int(C.get(cfg, "IMG_CHANNELS", 1)))
    weights = _weights(params, batch_stats, dev)
    x = torch.zeros(x_shape, dtype=torch.float32, device=dev)
    with torch.inference_mode(False), torch.no_grad():
        program = torch.export.export(_Program(model, cfg), (weights, x),
                                      strict=False)

    # the program keeps its example inputs, the weights among them, and
    # would save them: the weights ride in weights.npz only
    program.example_inputs = None
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT))
    os.replace(save_weights(out_dir, flax_to_state_dict(params,
                                                         batch_stats)),
               os.path.join(out_dir, WEIGHTS))
    with open(os.path.join(out_dir, META), "w") as fh:
        json.dump({"x_shape": list(x_shape), "dim": list(dim),
                   "mask_classes": int(C.get(cfg, "MASK_CLASSES", 2)),
                   "config": _json_safe(cfg), "device": dev.type}, fh)
    return out_dir


def load_exported(out_dir: str, device="cuda") -> Tuple[object, Dict]:
    """(callable, meta) of an artifact directory. The callable takes
    ``(weights, x)``, the weights from ``load_exported_weights`` and x a
    [B, *DIM, C] float32 tensor of ``x_shape`` on ``device``, and needs no
    model code. ``device`` must be of the type the program was traced on."""
    from cmrtpu_torch.predict.predictor import resolve_device

    path = os.path.join(out_dir, ARTIFACT)
    if not os.path.exists(path) and os.path.exists(
            os.path.join(out_dir, CMRTPU_ARTIFACT)):
        raise ValueError(
            f"{out_dir} is a cmrtpu (jax.export StableHLO) artifact; export "
            "the fold for cmrtpu_torch with `python -m cmrtpu_torch.cli.export"
            " -exp <fold> -out <dir>`")
    with open(os.path.join(out_dir, META)) as fh:
        meta = json.load(fh)
    dev = resolve_device(device)
    if dev.type != meta["device"]:
        raise ValueError(
            f"the artifact in {out_dir} was traced on {meta['device']!r} and "
            f"is bound to it; it cannot serve on {dev.type!r} — export the "
            f"fold again with --device {dev.type}")
    return torch.export.load(path).module(), meta


def load_exported_weights(out_dir: str, device="cuda"
                          ) -> Dict[str, torch.Tensor]:
    """The exported program's weights input, from ``weights.npz`` (any
    npz of the same model in cmrtpu's layout), on ``device``."""
    from cmrtpu_torch.predict.predictor import resolve_device

    params, batch_stats = load_weights(os.path.join(out_dir, WEIGHTS))
    return _weights(params, batch_stats, resolve_device(device))
