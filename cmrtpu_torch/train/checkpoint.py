"""Weights-only checkpoints in the ``cmrtpu`` ``model.npz`` layout, and the
bridge between the flax variable tree and a torch ``state_dict``.

Counterpart of ``cmrtpu/train/checkpoint.py:29-119``. A ``model.npz`` holds
flat ``params/<flax path>`` and ``batch_stats/<flax path>`` keys, e.g.
``params/DownBlock_0/ConvBlock_1/Conv_0/kernel``, or under a hybrid's
trunk ``params/unet_2d/DownBlock_0/...``. The torch modules of
``cmrtpu_torch.models`` carry the same names, so the bridge is:

  flax leaf                           torch state_dict entry
  ``.../Conv_0/kernel`` HWIO, DHWIO   ``....Conv_0.weight`` OIHW, OIDHW
  (``head``, ``head_<name>`` alike;   (a (2+1)D block's 2D ``Conv_0``
  a (2+1)D block's is HWIO in a 3D    is a 4D weight in a 3D net)
  net)
  ``.../ConvTranspose_0/kernel``      ``....ConvTranspose_0.weight``
  HWIO, DHWIO                         [in, out, *k], flipped on every
                                      spatial axis
  ``.../GroupNorm_0/scale``           ``....GroupNorm_0.weight`` (BatchNorm_0
                                      alike)
  ``.../bias``                        ``....bias``
  batch_stats ``.../mean``            ``....running_mean``
  batch_stats ``.../var``             ``....running_var``
  ``.../QuantConv_0/kernel_q`` int8   ``....QuantConv_0.kernel_q`` int8
  HWIO, DHWIO                         OIHW, OIDHW (the int8 twin)
  ``.../QuantConv_0/{w_scale,         the same names, as they are
  act_scale}``
  ``.../WSConv_0/kernel`` HWIO, DHWIO ``....WSConv_0.weight`` OIHW, OIDHW
  ``.../WSConv_0/gain``               ``....WSConv_0.gain``

flax's ``ConvTranspose`` does not flip its kernel (``transpose_kernel``
False) and torch's transposed convolution, the gradient of a convolution,
does; the flip in the bridge makes the two compute the same function.

A model trained by either package serves from the other.

A model with no cmrtpu counterpart, and so no flax layout (the
Swin-Unet, ``models/swin_unet.py``: no entry of its state_dict has a flax
counterpart), is saved in ``model.npz`` under its own ``state_dict``
names: ``state_dict/<name>`` keys, restored as they are by
``load_weights_for_model``.

The full train state for a resume (cmrtpu keeps it with Orbax under
``MODEL_PATH/state``) is one ``torch.save`` file, ``MODEL_PATH/state.pt``:
the model's state_dict, the optimizer's rule name and state_dict (its
moments, step count and learning rate), the step, the learning rate, the
EMA shadow and the states of the trainer's dropout generator and the
loop's augmentation and matcher generator. ``AsyncCheckpointWriter``
writes in the background, latest-wins per path; ``device_snapshot`` copies
a state on the card first, since the next optimizer step updates the
parameters and moments in place.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from cmrtpu_torch.parallel.mesh import is_main_process
from cmrtpu_torch.utils.io_utils import ensure_dir

WEIGHTS_NAME = "model.npz"
STATE_NAME = "state.pt"
# the key prefix of a model.npz in a model's own state_dict names
NATIVE_PREFIX = "state_dict/"

_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var",
             "kernel_q": "kernel_q", "w_scale": "w_scale",
             "act_scale": "act_scale", "gain": "gain"}


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


# a conv kernel's rank: 4 in the 2D U-Net and a (2+1)D block's spatial
# conv, 5 in the 3D U-Net
_KERNEL_NDIMS = (4, 5)


def _kind(module: str) -> str:
    """'conv_t', 'conv', 'qconv' (the int8 twin's QuantConv), 'wsconv'
    (the weight-standardised conv) or 'norm' by the flax module name, ''
    otherwise."""
    if module.startswith("QuantConv"):
        return "qconv"
    if module.startswith("WSConv"):
        return "wsconv"
    if module.startswith("ConvTranspose"):
        return "conv_t"
    if module.startswith("Conv") or module == "head" \
            or module.startswith("head_"):
        return "conv"
    if module.startswith(("GroupNorm", "BatchNorm")):
        return "norm"
    return ""


def _flip_spatial(arr: np.ndarray, rank: int) -> np.ndarray:
    return arr[(slice(None, None, -1),) * rank]


def flax_to_state_dict(params: Dict, batch_stats: Dict = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested flax trees (numpy leaves) -> torch ``state_dict``. A conv
    kernel [*k, I, O] becomes [O, I, *k] (an int8 ``kernel_q`` too, its
    dtype kept); a transposed one is flipped on its spatial axes and
    becomes [I, O, *k]. A leaf that is not a conv's, a norm's, a
    QuantConv's or a bias (a kernel of another rank, a scale outside a
    norm) raises."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in {**_flatten(params),
                      **_flatten(batch_stats or {})}.items():
        leaf, kind = path[-1], _kind(path[-2]) if len(path) > 1 else ""
        conv = kind in ("conv", "conv_t", "wsconv")
        valid = leaf in _TO_TORCH and (
            (leaf == "kernel" and conv and arr.ndim in _KERNEL_NDIMS)
            or (leaf == "gain" and kind == "wsconv" and arr.ndim == 1)
            or (leaf == "scale" and kind == "norm" and arr.ndim == 1)
            or (leaf == "bias" and kind and arr.ndim == 1)
            or (leaf in ("mean", "var") and kind == "norm" and arr.ndim == 1)
            or (leaf == "kernel_q" and kind == "qconv"
                and arr.ndim in _KERNEL_NDIMS and arr.dtype == np.int8)
            or (leaf in ("w_scale", "act_scale") and kind == "qconv"
                and arr.ndim == 1))
        if not valid:
            raise ValueError(
                f"{'/'.join(path)} {arr.shape}: not a leaf of the U-Nets "
                "and hybrids that cmrtpu_torch ports")
        if leaf in ("kernel", "kernel_q"):
            rank = arr.ndim - 2
            if kind == "conv_t":
                arr = _flip_spatial(arr, rank).transpose(
                    rank, rank + 1, *range(rank))
            else:
                arr = arr.transpose(rank + 1, rank, *range(rank))
        module = ".".join(path[:-1])
        out[f"{module}.{_TO_TORCH[leaf]}"] = torch.tensor(arr.copy())
    return out


def _flax_entry(name: str, tensor: torch.Tensor):
    """(tree, path, array) of one state_dict entry in the flax layout:
    tree 'params' or 'batch_stats'; None for an entry with no flax
    counterpart (decided from the name and rank alone)."""
    *module, leaf = name.split(".")
    kind, ndim = (_kind(module[-1]) if module else ""), tensor.dim()

    def arr() -> np.ndarray:
        return tensor.detach().cpu().numpy()

    if leaf == "weight" and kind in ("conv", "conv_t", "wsconv") \
            and ndim in _KERNEL_NDIMS:
        rank = ndim - 2
        if kind == "conv_t":  # [I, O, *k] -> [*k, I, O], unflipped
            out = _flip_spatial(arr().transpose(*range(2, rank + 2), 0, 1),
                                rank)
        else:  # [O, I, *k] -> [*k, I, O]
            out = arr().transpose(*range(2, rank + 2), 1, 0)
        return "params", (*module, "kernel"), np.ascontiguousarray(out)
    if leaf == "kernel_q" and kind == "qconv" and ndim in _KERNEL_NDIMS:
        rank = ndim - 2  # [O, I, *k] -> [*k, I, O], int8 kept
        return "params", (*module, "kernel_q"), np.ascontiguousarray(
            arr().transpose(*range(2, rank + 2), 1, 0))
    if (leaf in ("w_scale", "act_scale") and kind == "qconv"
            or leaf == "gain" and kind == "wsconv") and ndim == 1:
        return "params", (*module, leaf), arr()
    if leaf == "weight" and kind == "norm" and ndim == 1:
        return "params", (*module, "scale"), arr()
    if leaf == "bias" and kind and ndim == 1:
        return "params", (*module, "bias"), arr()
    if leaf in ("running_mean", "running_var") and kind == "norm":
        return "batch_stats", (*module, leaf[len("running_"):]), arr()
    return None


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict, Dict]:
    """torch ``state_dict`` -> (params, batch_stats) nested numpy trees, the
    exact inverse of ``flax_to_state_dict``. An entry that is not one of
    the U-Net's raises."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in state_dict.items():
        entry = _flax_entry(name, tensor)
        if entry is None:
            raise ValueError(f"{name} {tuple(tensor.shape)}: no flax "
                             "counterpart in the U-Nets and hybrids")
        tree, path, arr = entry
        trees[tree][path] = arr
    return _unflatten(trees["params"]), _unflatten(trees["batch_stats"])


def has_cmrtpu_layout(state_dict: Mapping[str, torch.Tensor]) -> bool:
    """Whether ``state_dict`` is a model's with a cmrtpu layout: False
    where no entry has a flax counterpart (a model cmrtpu does not have,
    such as the Swin-Unet), which ``model.npz`` keeps in its own names. A
    state_dict with some such entries is a U-Net's or a hybrid's, and
    ``state_dict_to_flax`` raises for the others."""
    return any(_flax_entry(n, t) is not None for n, t in state_dict.items())


def _atomic_write(path: str, write) -> str:
    """``write(file)`` into a unique temp file beside ``path``, then rename,
    so a crash mid-write never leaves a truncated file and two writers of
    one path never truncate each other's temp file."""
    directory = os.path.dirname(path)
    ensure_dir(directory)
    fd, tmp = tempfile.mkstemp(prefix=".tmp.", suffix=os.path.splitext(
        path)[1], dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def save_weights(model_path: str,
                 weights: Union[nn.Module, Mapping[str, torch.Tensor]]) -> str:
    """Write ``model_path/model.npz`` in the cmrtpu layout from a model or
    a state_dict (the serving weights: the EMA shadow with EMA on), or in
    the state_dict's own names for a model with no cmrtpu layout. Over a
    process group only rank 0 writes (every rank returns the path)."""
    if not is_main_process():
        return os.path.join(model_path, WEIGHTS_NAME)
    state = weights.state_dict() if isinstance(weights, nn.Module) \
        else weights
    if not has_cmrtpu_layout(state):
        blobs = {NATIVE_PREFIX + name: t.detach().cpu().numpy()
                 for name, t in state.items()}
        return _atomic_write(os.path.join(model_path, WEIGHTS_NAME),
                             lambda fh: np.savez(fh, **blobs))
    params, stats = state_dict_to_flax(state)
    blobs = {f"params/{'/'.join(k)}": v for k, v in _flatten(params).items()}
    blobs.update({f"batch_stats/{'/'.join(k)}": v
                  for k, v in _flatten(stats).items()})
    return _atomic_write(os.path.join(model_path, WEIGHTS_NAME),
                         lambda fh: np.savez(fh, **blobs))


def save_train_state(ckpt_dir: str, state: Dict) -> str:
    """Write a full train state (``Trainer.train_state``, or a snapshot of
    it) to ``ckpt_dir/state.pt``; tensors go to the host first, so the file
    loads on any device. Over a process group only rank 0 writes."""
    if not is_main_process():
        return os.path.join(ckpt_dir, STATE_NAME)

    def to_host(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu()
        if isinstance(tree, dict):
            return {k: to_host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to_host(v) for v in tree)
        return tree

    host = to_host(state)
    return _atomic_write(os.path.join(ckpt_dir, STATE_NAME),
                         lambda fh: torch.save(host, fh))


def restore_train_state(ckpt_dir: str) -> Dict:
    """The full train state written by ``save_train_state`` (tensors on
    the host). FileNotFoundError when there is none."""
    path = os.path.join(ckpt_dir, STATE_NAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def device_snapshot(tree):
    """A copy of every tensor of ``tree`` on its own device. The optimizer
    step updates parameters and moments in place, so a state handed to a
    background write must be copied before the loop steps again."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: device_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_snapshot(v) for v in tree)
    return tree


class AsyncCheckpointWriter:
    """Latest-wins background checkpoint writer (cmrtpu's
    ``AsyncCheckpointWriter``): the callback snapshots the state on the
    card and returns; the transfer to the host and the file IO overlap the
    next epochs. Only the newest pending write is kept. ``flush`` blocks
    until the last submitted write is on disk and re-raises the last write
    failure, so a fold whose checkpoint is missing or stale fails."""

    def __init__(self):
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending = None
        self._busy = False
        self._thread = None
        self._error = None

    def submit(self, fn, *args) -> None:
        with self._lock:
            self._pending = (fn, args)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()
            self._wake.notify_all()

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._pending is None:
                    self._wake.wait()
                fn, args = self._pending
                self._pending = None
                self._busy = True
            try:
                fn(*args)
                with self._lock:
                    self._error = None  # a later good write supersedes
            except Exception as e:
                logging.exception("async checkpoint write failed")
                with self._lock:
                    self._error = e
            finally:
                # drop the snapshot before parking: an idle writer must not
                # hold a dead trainer's tensors on the card
                fn = args = None
                with self._lock:
                    self._busy = False
                    self._wake.notify_all()

    def flush(self) -> None:
        with self._lock:
            while self._pending is not None or self._busy:
                self._wake.wait(timeout=0.1)
            if self._error is not None:
                error, self._error = self._error, None
                raise RuntimeError(
                    "async checkpoint write failed; the checkpoint on disk "
                    "is missing or stale") from error


def _npz_path(model_path: str) -> str:
    return model_path if model_path.endswith(".npz") \
        else os.path.join(model_path, WEIGHTS_NAME)


def load_weights(model_path: str) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats) nested numpy trees from a model.npz
    file or its directory. An int8 twin written before cmrtpu's round 4
    stored a scalar ``act_scale``; it is broadcast to the per-input-channel
    vector of its ``kernel_q``, as cmrtpu's ``load_weights`` does
    (``cmrtpu/train/checkpoint.py:74-82``). A file in a model's own
    state_dict names has no such trees and raises ValueError."""
    path = _npz_path(model_path)
    params, stats = {}, {}
    with np.load(path) as blobs:
        if any(k.startswith(NATIVE_PREFIX) for k in blobs.files):
            raise ValueError(f"{path} holds a model with no cmrtpu layout "
                             "(state_dict names); restore it with "
                             "load_weights_for_model")
        for key in blobs.files:
            prefix, rest = key.split("/", 1)
            target = params if prefix == "params" else stats
            target[tuple(rest.split("/"))] = blobs[key]
    for key, val in list(params.items()):
        if key[-1] == "act_scale" and np.size(val) == 1:
            kernel = params.get(key[:-1] + ("kernel_q",))
            if kernel is not None:
                params[key] = np.full((kernel.shape[-2],),
                                      float(np.ravel(val)[0]), np.float32)
    return _unflatten(params), _unflatten(stats)


def load_weights_for_model(model_path: str, model: nn.Module,
                           config: Dict) -> nn.Module:
    """Load ``model.npz`` into ``model`` (strict: every key and shape must
    match). A model directory with a keras ``model.h5`` and no
    ``model.npz`` (the reference's published folds) is imported instead
    (``train/keras_import.py``), walked in the order that ``config``'s
    model gives; that route needs h5py. A ``model.npz`` in a model's own
    state_dict names loads as it is."""
    npz = _npz_path(model_path)
    h5 = model_path if model_path.endswith(".h5") \
        else os.path.join(model_path, "model.h5")
    if not os.path.exists(npz) and os.path.exists(h5):
        from cmrtpu_torch.train.keras_import import import_keras_unet_weights
        trees = import_keras_unet_weights(model, h5, config)
        model.load_state_dict(flax_to_state_dict(trees["params"],
                                                 trees["batch_stats"]))
        return model
    with np.load(npz) as blobs:
        native = {k[len(NATIVE_PREFIX):]: torch.from_numpy(blobs[k])
                  for k in blobs.files if k.startswith(NATIVE_PREFIX)}
    if native:
        model.load_state_dict(native)
        return model
    params, stats = load_weights(model_path)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return model


def load_pretrained_model(model_path: str, model: nn.Module,
                          config: Dict):
    """The fallback chain of model loading (ref: load_pretrained_model,
    src/models/ModelUtils.py:7-73; cmrtpu's ``load_pretrained_model``):
    the full train state ``state.pt`` when ``model_path`` holds one, else
    ``model.npz``, else a keras ``model.h5`` (walked by ``config``). Returns
    ``(model, state)``, ``state`` None unless it came from ``state.pt``;
    with a state the weights are the live ones, not the EMA shadow. A
    ``state.pt`` that does not load into ``model`` raises, as a resume
    does (cmrtpu falls through to the weights)."""
    if os.path.exists(os.path.join(model_path, STATE_NAME)):
        state = restore_train_state(model_path)
        model.load_state_dict(state["model"])
        return model, state
    return load_weights_for_model(model_path, model, config), None
