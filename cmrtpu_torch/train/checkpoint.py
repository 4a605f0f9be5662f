"""Weights-only checkpoints in the ``cmrtpu`` ``model.npz`` layout, and the
bridge between the flax variable tree and a torch ``state_dict``.

Counterpart of ``cmrtpu/train/checkpoint.py:29-119``. A ``model.npz`` holds
flat ``params/<flax path>`` and ``batch_stats/<flax path>`` keys, e.g.
``params/DownBlock_0/ConvBlock_1/Conv_0/kernel``. The torch modules of
``cmrtpu_torch.models.unet`` carry the same names, so the bridge is:

  flax leaf                           torch state_dict entry
  ``.../Conv_0/kernel`` HWIO          ``....Conv_0.weight`` OIHW
  ``.../ConvTranspose_0/kernel`` HWIO ``....ConvTranspose_0.weight``
                                      [in, out, kh, kw], flipped in H, W
  ``.../GroupNorm_0/scale``           ``....GroupNorm_0.weight`` (BatchNorm_0
                                      alike)
  ``.../bias``                        ``....bias``
  batch_stats ``.../mean``            ``....running_mean``
  batch_stats ``.../var``             ``....running_var``

flax's ``ConvTranspose`` does not flip its kernel (``transpose_kernel``
False) and torch's transposed convolution, the gradient of a convolution,
does; the flip in the bridge makes the two compute the same function.

A model trained by either package serves from the other.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from cmrtpu_torch.utils.io_utils import ensure_dir

WEIGHTS_NAME = "model.npz"

_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flatten(val, prefix + (key,)))
        else:
            flat[prefix + (key,)] = np.asarray(val)
    return flat


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def flax_to_state_dict(params: Dict, batch_stats: Dict = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested flax trees (numpy leaves) -> torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in {**_flatten(params),
                      **_flatten(batch_stats or {})}.items():
        leaf = path[-1]
        if leaf not in _TO_TORCH or (leaf == "kernel" and arr.ndim != 4):
            raise ValueError(
                f"{'/'.join(path)} {arr.shape}: not a leaf of the 2D U-Net "
                "that cmrtpu_torch ports")
        if leaf == "kernel" and _transposed(path[-2]):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # -> [I, O, kh, kw]
        elif leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        module = ".".join(path[:-1])
        out[f"{module}.{_TO_TORCH[leaf]}"] = torch.tensor(arr.copy())
    return out


def _transposed(module: str) -> bool:
    return module.startswith("ConvTranspose")


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict, Dict]:
    """torch ``state_dict`` -> (params, batch_stats) nested numpy trees."""
    params, stats = {}, {}
    for name, tensor in state_dict.items():
        *module, leaf = name.split(".")
        arr = tensor.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim == 4 and _transposed(module[-1]):
            params[(*module, "kernel")] = np.ascontiguousarray(
                arr.transpose(2, 3, 0, 1)[::-1, ::-1])  # -> HWIO, unflipped
        elif leaf == "weight" and arr.ndim == 4:
            params[(*module, "kernel")] = arr.transpose(2, 3, 1, 0)  # -> HWIO
        elif leaf == "weight":
            params[(*module, "scale")] = arr
        elif leaf == "bias":
            params[(*module, "bias")] = arr
        elif leaf == "running_mean":
            stats[(*module, "mean")] = arr
        elif leaf == "running_var":
            stats[(*module, "var")] = arr
        else:
            raise ValueError(f"{name}: no flax counterpart")
    return _unflatten(params), _unflatten(stats)


def save_weights(model_path: str, model: nn.Module) -> str:
    """Write ``model_path/model.npz`` in the cmrtpu layout, atomically
    (unique temp file, then rename)."""
    ensure_dir(model_path)
    params, stats = state_dict_to_flax(model.state_dict())
    blobs = {f"params/{'/'.join(k)}": v for k, v in _flatten(params).items()}
    blobs.update({f"batch_stats/{'/'.join(k)}": v
                  for k, v in _flatten(stats).items()})
    path = os.path.join(model_path, WEIGHTS_NAME)
    fd, tmp = tempfile.mkstemp(prefix=".tmp.", suffix=".npz", dir=model_path)
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **blobs)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_weights(model_path: str) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats) nested numpy trees from a model.npz
    file or its directory."""
    path = model_path if model_path.endswith(".npz") \
        else os.path.join(model_path, WEIGHTS_NAME)
    params, stats = {}, {}
    with np.load(path) as blobs:
        for key in blobs.files:
            prefix, rest = key.split("/", 1)
            target = params if prefix == "params" else stats
            target[tuple(rest.split("/"))] = blobs[key]
    return _unflatten(params), _unflatten(stats)


def load_weights_for_model(model_path: str, model: nn.Module) -> nn.Module:
    """Load ``model.npz`` into ``model`` (strict: every key and shape must
    match). A keras ``model.h5`` is not ported yet."""
    npz = model_path if model_path.endswith(".npz") \
        else os.path.join(model_path, WEIGHTS_NAME)
    h5 = model_path if model_path.endswith(".h5") \
        else os.path.join(model_path, "model.h5")
    if not os.path.exists(npz) and os.path.exists(h5):
        raise NotImplementedError(
            f"{h5}: keras weight import is not ported to cmrtpu_torch yet "
            "(ROADMAP 3.7); convert it with cmrtpu first")
    params, stats = load_weights(model_path)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return model
