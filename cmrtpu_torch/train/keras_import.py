"""Import the reference's published keras weights-only ``model.h5`` into
the port's U-Net — counterpart of ``cmrtpu/train/keras_import.py``.

The reference's trained folds exist only as keras ``model.h5`` files
(ref: src/models/predict_model.py:75-76, the fallback chain of
src/models/ModelUtils.py:7-73). The file's root attribute ``layer_names``
lists the model's layers in creation order; each weighted layer's group
lists its datasets in ``weight_names``. Weights map by ORDER, not by name
(keras auto-names depend on the models built before), walking the fixed
creation order (ref: src/models/Unets.py:755-869,
src/models/KerasLayers.py:660-777):

    per encoder block:  conv [bn] conv [bn]
    bottleneck:         conv [bn] conv [bn]
    per decoder block:  up-conv, conv [bn] conv [bn]
    head:               1x1 conv ('unet')

The walk fills the flax-named numpy trees that ``state_dict_to_flax`` gives
for the port's model, which ``flax_to_state_dict`` then loads, so the
layouts are flax's: keras Conv kernels are HWIO as there; a keras
Conv2DTranspose kernel (kh, kw, out, in) is flipped on its spatial axes and
its channel axes swapped; BatchNorm's gamma, beta, moving mean and variance
become scale, bias, mean, var.

h5py is imported only inside ``read_keras_h5_weights``: the card has none.
There, convert on a host with h5py (``load_weights_for_model`` of the fold,
then ``save_weights`` to ``model.npz``) and serve the npz.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
from torch import nn

from cmrtpu_torch import config as C
from cmrtpu_torch.train.checkpoint import state_dict_to_flax


def read_keras_h5_weights(path: str
                          ) -> List[Tuple[str, List[Tuple[str, np.ndarray]]]]:
    """All weighted layers of a keras weights-only h5, in stored layer order:
    [(layer_name, [(weight_name, array), ...]), ...]. Raises ImportError
    naming the npz route where h5py cannot be imported."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            f"{path}: reading a keras model.h5 needs h5py, which this host "
            "lacks. On a host with h5py, load the fold with "
            "cmrtpu_torch.train.checkpoint.load_weights_for_model(<model "
            "dir>, model, config) and write model.npz with save_weights(<model "
            "dir>, model); this host then loads the model.npz") from exc

    def _s(v) -> str:
        return v.decode() if isinstance(v, bytes) else str(v)

    layers = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name in (_s(n) for n in root.attrs["layer_names"]):
            group = root[name]
            weight_names = [_s(n) for n in group.attrs.get("weight_names", [])]
            if not weight_names:
                continue  # Input/Dropout/MaxPool/UpSampling/Concat layers
            layers.append((name, [(w, np.asarray(group[w]))
                                  for w in weight_names]))
    return layers


def _leaf(weight_name: str) -> str:
    return weight_name.split("/")[-1].split(":")[0]


def _classify(weights: List[Tuple[str, np.ndarray]]) -> str:
    """'conv' (kernel+bias), 'bn' (gamma/beta/mean/var) or 'other'."""
    names = [_leaf(w) for w, _ in weights]
    if "kernel" in names:
        return "conv"
    if "moving_variance" in names or ("gamma" in names and "beta" in names):
        return "bn"
    return "other"


def _conv_arrays(weights, transpose_kernel=False):
    arrs = {_leaf(name): arr for name, arr in weights}
    kernel, bias = arrs.get("kernel"), arrs.get("bias")
    if transpose_kernel:
        # keras stores a transposed conv's kernel as (spatial..., out, in)
        # for TF's gradient-of-a-strided-conv; flax's ConvTranspose runs a
        # fractionally strided conv with its (spatial..., in, out) kernel
        # as it is: the two agree after a flip of every spatial axis and a
        # swap of the channel axes
        spatial_flip = tuple(slice(None, None, -1)
                             for _ in range(kernel.ndim - 2))
        kernel = np.swapaxes(kernel[spatial_flip], -1, -2)
    return kernel, bias


class _Assigner:
    """Walks the keras weighted-layer stream while filling the flax trees."""

    def __init__(self, layers, params, batch_stats):
        self.stream = list(layers)
        self.pos = 0
        self.params = params
        self.batch_stats = batch_stats

    def _next(self, kind: str):
        if self.pos >= len(self.stream):
            raise ValueError(
                f"keras weight stream exhausted while looking for a {kind} "
                f"layer — model/config mismatch (DEPTH/BATCH_NORMALISATION/"
                f"USE_UPSAMPLE must match the training config)")
        name, weights = self.stream[self.pos]
        got = _classify(weights)
        if got != kind:
            raise ValueError(
                f"expected a {kind} layer at stream position {self.pos} "
                f"but found '{name}' ({got}) — model/config mismatch")
        self.pos += 1
        return name, weights

    def _put(self, name, path, node, leaf, arr):
        if node[leaf].shape != arr.shape:
            raise ValueError(
                f"shape mismatch importing '{name}' into "
                f"{'/'.join(path)}/{leaf}: h5 {arr.shape} vs model "
                f"{node[leaf].shape}")
        node[leaf] = arr.astype(np.float32)

    def conv(self, *path: str, transpose_kernel: bool = False):
        name, weights = self._next("conv")
        kernel, bias = _conv_arrays(weights, transpose_kernel)
        node = self._dig(self.params, path)
        for leaf, arr in (("kernel", kernel), ("bias", bias)):
            self._put(name, path, node, leaf, arr)

    def bn(self, *path: str):
        name, weights = self._next("bn")
        arrs = {_leaf(w): arr for w, arr in weights}
        pnode = self._dig(self.params, path)
        snode = self._dig(self.batch_stats, path)
        for leaf, key, node in (("scale", "gamma", pnode),
                                ("bias", "beta", pnode),
                                ("mean", "moving_mean", snode),
                                ("var", "moving_variance", snode)):
            self._put(name, path, node, leaf, arrs[key])

    @staticmethod
    def _dig(tree, path):
        node = tree
        for key in path:
            if key not in node:
                raise ValueError(f"the model has no node {'/'.join(path)} "
                                 f"(missing '{key}')")
            node = node[key]
        return node

    def done(self):
        if self.pos != len(self.stream):
            leftover = [n for n, _ in self.stream[self.pos:]]
            raise ValueError(
                f"{len(leftover)} unconsumed keras weight layers after "
                f"import: {leftover} — model/config mismatch")


def import_keras_unet_weights(model: nn.Module, h5_path: str,
                              config: Dict) -> Dict[str, Dict]:
    """A reference ``model.h5`` mapped onto the flax-named trees of the
    port's U-Net built from the same config: {'params', 'batch_stats'} of
    numpy leaves, for ``flax_to_state_dict``. The model is not changed.
    Raises ValueError on any structural or shape mismatch."""
    depth = int(C.get(config, "DEPTH", 4))
    batch_norm = bool(C.get(config, "BATCH_NORMALISATION", True))
    use_upsample = bool(C.get(config, "USE_UPSAMPLE", True))
    params, batch_stats = state_dict_to_flax(model.state_dict())
    a = _Assigner(read_keras_h5_weights(h5_path), params, batch_stats)

    def conv_block(*prefix):
        a.conv(*prefix, "Conv_0")
        if batch_norm:
            a.bn(*prefix, "BatchNorm_0")

    for level in range(depth):
        conv_block(f"DownBlock_{level}", "ConvBlock_0")
        conv_block(f"DownBlock_{level}", "ConvBlock_1")
    conv_block("ConvBlock_0")  # bottleneck
    conv_block("ConvBlock_1")
    for level in range(depth):
        up = f"UpBlock_{level}"
        if use_upsample:
            a.conv(up, "Conv_0")
        else:
            a.conv(up, "ConvTranspose_0", transpose_kernel=True)
        conv_block(up, "ConvBlock_0")
        conv_block(up, "ConvBlock_1")
    a.conv("head")  # the 1x1 sigmoid conv named 'unet' in the reference
    a.done()
    logging.info("imported keras weights from %s (%d weighted layers)",
                 h5_path, a.pos)
    return {"params": params, "batch_stats": batch_stats}
