"""Restored model + batched forward, thresholding, the CC_FILTER cleaner and
the inference entry points ``pred_fold`` (one fold's test patients),
``predict_4d_on_2d_cv`` (a trained 2D CV over whole cine sequences) and
``predict_override_twin`` (every fold again with predict-time overrides)
— counterpart of ``cmrtpu/predict/predictor.py``.

``cmrtpu.predict.predictor`` imports jax at module level, so its numpy-only
functions are re-implemented here over the port's own copies of the host
modules (``config``, ``io``, ``ops.resample``, ``pipeline.transforms``);
``preprocess_model_input`` is one batched torch pass on the caller's device
that keeps numpy's arithmetic.
The model code is imported where a ``Predictor`` is built, so a process
that serves an exported artifact through ``predict/serving.py`` never
loads ``cmrtpu_torch.models``.
"""

from __future__ import annotations

import functools
import glob
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.data.dataset import fold_patients, get_trainings_files
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.ops import resample as R
from cmrtpu_torch.ops.connected_components import (clean_prediction_2d_cc,
                                                   clean_prediction_3d_cc)
from cmrtpu_torch.pipeline import transforms as T
from cmrtpu_torch.pipeline.generator import DataGenerator, finalize_batch
from cmrtpu_torch.predict.postprocess import undo_generator_steps
from cmrtpu_torch.train.checkpoint import (WEIGHTS_NAME,
                                           load_weights_for_model)
from cmrtpu_torch.utils.io_utils import ensure_dir
from cmrtpu_torch.utils.profiling import span

# pred_fold's spans at DEBUG, each with a dict in ``record.timing``: its
# start, every patient-phase with its stage seconds, and its end with the
# wall seconds of the call (a handler on this logger reads them);
# predict_4d_on_2d_cv's likewise, as events '4d_start', '4d_file' (one per
# cine) and '4d_end'
TIMING_LOG = logging.getLogger(__name__ + ".timing")

_BUCKET = 8  # Predictor.predict pads slice batches to a multiple of this


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without CUDA raises — the CPU
    runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def cc_clean_fn(cfg: Dict):
    """The CC_FILTER knob's cleaner, or None when off. Truthy and '2d' keep
    the biggest 4-connected component per label per slice; '3d' keeps the
    biggest 26-connected component per label in the whole [Z, H, W]
    volume, so an isolated blob on a slice without a true detection goes
    too (cmrtpu's ``cc_clean_fn``)."""
    mode = C.get(cfg, "CC_FILTER", False)
    if isinstance(mode, str):
        norm = mode.strip().lower()
        if norm in ("", "false", "none", "0"):
            return None
        if norm == "3d":
            return clean_prediction_3d_cc
        if norm in ("2d", "true", "1"):
            return clean_prediction_2d_cc
        raise ValueError(
            f"CC_FILTER={mode!r}: expected a boolean, '2d' or '3d'")
    return clean_prediction_2d_cc if mode else None


def _supervised(model_path: str) -> bool:
    """True when ``model.npz`` holds a deep-supervision branch: a
    ``Conv_0`` beside the U-Net's head, or beside a hybrid trunk's. Only
    the archive's names are read."""
    npz = model_path if model_path.endswith(".npz") \
        else os.path.join(model_path, WEIGHTS_NAME)
    if not os.path.exists(npz):
        return False
    with np.load(npz) as blobs:
        names = set(blobs.files)
    return any(f"params/{trunk}Conv_0/kernel" in names
               for trunk in ("", "unet_2d/", "unet_3d/"))


class Predictor:
    """Restored model + batched forward on an explicit device. The model
    is MODEL_VARIANT's, with the deep-supervision branch when the weights
    hold one (cmrtpu's Predictor builds the model without it and flax
    ignores the branch's weights). With ``TTA`` the forward is the rot90
    orbit's (``predict/tta.py``, by ``TTA_MODE``), so ``pred_fold``,
    ``cli.predict`` and the twins inherit it."""

    def __init__(self, config: Dict, model_path: Optional[str] = None,
                 device="cuda"):
        from cmrtpu_torch.models.hybrids import get_model

        self.config = C.normalise_config(config)
        self.device = resolve_device(device)
        model_path = model_path or C.get(self.config, "MODEL_PATH")
        self.model = get_model(self.config,
                               supervision=_supervised(model_path))
        load_weights_for_model(model_path, self.model, self.config)
        self.model.to(self.device).eval()
        self._apply = self.model
        if C.get(self.config, "TTA", False):
            from cmrtpu_torch.predict.tta import tta_forward_from_config
            self._apply = tta_forward_from_config(self.model, self.config)

    @torch.inference_mode()
    def _forward(self, x):
        """[N, H, W, C] float32 (an array, or a tensor, which is used where
        it lies on the device) -> [N, H, W, classes] probabilities (a dict
        of them per head for a HEADS model), left on the device (the call
        returns before the device finishes)."""
        return self._apply(torch.as_tensor(x, device=self.device))

    def predict(self, x, to_host: bool = True):
        """Batched forward of an array or tensor, padded on the device to a
        multiple of ``_BUCKET`` and trimmed back to the input's batch size:
        a numpy array, or a dict of them per head; with ``to_host`` False
        the tensors stay on the device."""
        x = torch.as_tensor(x, device=self.device)
        n = x.shape[0]
        padded = -(-n // _BUCKET) * _BUCKET
        if padded != n:
            x = torch.cat([x, x.new_zeros((padded - n, *x.shape[1:]))])
        out = self._forward(x)
        return to_numpy(out, n) if to_host else _rows(out, n)


def _rows(out, n: int):
    """The first ``n`` rows of a forward's output (a tensor, or a dict of
    tensors per head)."""
    if isinstance(out, dict):
        return {k: v[:n] for k, v in out.items()}
    return out[:n]


def to_numpy(out, n: int):
    """The first ``n`` rows of a forward's output (a tensor, or a dict of
    tensors per head) on the host."""
    out = _rows(out, n)
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy()


def filter_by_patient_id(p_id: str, f_names: List[str]) -> List[str]:
    return [elem for elem in f_names if p_id in elem]


def flatten_labels(channels: torch.Tensor, activation: str) -> torch.Tensor:
    """Channel probabilities -> uint8 flat labels on the tensor's device:
    sigmoid heads by the 0.5 threshold (ch0>0.5 -> 1, ch1>0.5 -> 2; later
    channels overwrite), softmax heads by argmax (0 = background; the
    first maximum wins)."""
    if str(activation) == "softmax":
        return channels.argmax(dim=-1).to(torch.uint8)
    flat = torch.zeros(channels.shape[:-1], dtype=torch.uint8,
                       device=channels.device)
    for c in range(channels.shape[-1]):
        flat[channels[..., c] > 0.5] = c + 1
    return flat


def flatten_head(channels: np.ndarray, activation: str) -> np.ndarray:
    """``flatten_labels`` of host channels, as float64 labels."""
    host = torch.from_numpy(np.ascontiguousarray(channels))
    return flatten_labels(host, activation).numpy().astype(np.float64)


def threshold_and_flatten(channels: np.ndarray) -> np.ndarray:
    """sigmoid channels -> flat float64 labels (ch0>0.5 -> 1, ch1>0.5 -> 2;
    later channels overwrite)."""
    return flatten_head(channels, "sigmoid")


def _head_outputs(cfg: Dict, preds, gts: Optional[np.ndarray]):
    """Per-head flat label volumes, [(file_suffix, pred_flat, gt_flat,
    label_values)] in HEADS order. The first sigmoid head (or the single
    head) owns the ``msk`` suffix, so the landmark evaluation holds
    unchanged; every other head writes ``_<name>.nrrd``. A softmax head's
    labels are 1..C-1 (0 is background), a sigmoid head's 1..C.
    ``gts=None`` (serve time): gt_flat is None."""
    heads = tuple(tuple(h) for h in C.get(cfg, "HEADS", ()) or ())
    if not heads:
        n_channels = np.asarray(preds).shape[-1] if gts is None \
            else gts.shape[-1]
        label_values = tuple(range(1, n_channels + 1))
        return [("msk", threshold_and_flatten(preds),
                 None if gts is None else threshold_and_flatten(gts),
                 label_values)]
    outputs = []
    offset = 0
    msk_taken = False
    for name, channels, act in heads:
        channels = int(channels)
        gt_h = None if gts is None else gts[..., offset:offset + channels]
        offset += channels
        softmax = str(act) == "softmax"
        label_values = tuple(range(1, channels)) if softmax \
            else tuple(range(1, channels + 1))
        suffix = str(name)
        if not softmax and not msk_taken:
            suffix, msk_taken = "msk", True
        outputs.append((suffix, flatten_head(preds[name], act),
                        None if gt_h is None else flatten_head(gt_h, act),
                        label_values))
    if not msk_taken:
        logging.warning(
            "HEADS=%s has no sigmoid head: no _msk.nrrd is written, so the "
            "landmark evaluation (which globs *msk.nrrd) will find no "
            "predictions — add a sigmoid landmark head or evaluate the "
            "per-head _<name>.nrrd families directly",
            [h[0] for h in heads])
    return outputs


def select_4d_landmark_head(cfg: Dict):
    """The head the 4D prediction tracks: the first sigmoid head (the one
    that owns the ``_msk`` files in ``_head_outputs``), else the first
    head's argmax labels. Returns ``(name, activation, cc_label_values)``; name
    and label values are None for a single-head model (its label values
    follow the output's channel count)."""
    heads = [tuple(h) for h in (C.get(cfg, "HEADS") or ())]
    if not heads:
        return None, "sigmoid", None
    head = next((h for h in heads if str(h[2]) != "softmax"), None)
    if head is not None:
        return str(head[0]), "sigmoid", tuple(range(1, int(head[1]) + 1))
    head = heads[0]
    logging.warning(
        "predict_4d_on_2d_cv: HEADS has no sigmoid landmark head; using "
        "head %r (argmax labels)", head[0])
    return str(head[0]), str(head[2]), tuple(range(1, int(head[1])))


def _linear_taps(n_out: int, out_spacing: float, in_spacing: float,
                 size: int, w_dtype: torch.dtype, dev: torch.device):
    """ITK's linear rule along one axis as ``ops/resample.py``'s
    ``_axis_gather_np`` computes it: each output index's low and high
    neighbours, their float64 weights (the fraction, and one less it,
    taken in ``w_dtype``, as the host code takes them in a floating
    input's dtype) and whether it lies inside the input."""
    coords = torch.arange(n_out, dtype=torch.float64, device=dev) \
        * (out_spacing / in_spacing)
    inside = (coords >= -0.5) & (coords < size - 0.5)
    c = coords.clamp(0.0, size - 1.0)
    lo = c.floor()
    w = (c - lo).to(w_dtype)
    lo = lo.long()
    return (lo, (lo + 1).clamp(max=size - 1), w.double(), (1 - w).double(),
            inside)


def _gather_linear(arr: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """float64 ``arr`` resampled along ``dim`` by ``_linear_taps``' taps:
    zero outside the input."""
    lo, hi, w, w1, inside = taps
    shape = [1] * arr.ndim
    shape[dim] = -1
    out = arr.index_select(dim, lo) * w1.view(shape) \
        + arr.index_select(dim, hi) * w.view(shape)
    return torch.where(inside.view(shape), out, 0.0)


def _quantile_rank(n: int, q):
    """numpy's "linear" quantile ``q`` (a numpy scalar, whose dtype numpy
    computes in) of ``n`` values: the 0-based ranks of its two neighbours
    and their weight."""
    v = (n - 1) * q
    if v >= n - 1:
        return n - 1, n - 1, q.dtype.type(0)
    lo = int(np.floor(v))
    return lo, lo + 1, v - q.dtype.type(lo)


def _quantiles(ordered: torch.Tensor, qs) -> List[torch.Tensor]:
    """numpy's "linear" quantiles of each row of ``ordered`` [N, P], its
    values sorted (one sort a row: ``torch.quantile`` refuses more than
    2**24 values), one [N] tensor a quantile in the dtype of its ``q``:
    numpy's lerp between the two neighbours, which counts from the upper
    one when the weight is 0.5 or more."""
    out = []
    for q in qs:
        lo, hi, t = _quantile_rank(ordered.shape[1], q)
        dt = getattr(torch, q.dtype.name)
        a, b = ordered[:, lo], ordered[:, hi]
        diff = (b - a).to(dt)
        if t >= 0.5:
            out.append(b.to(dt) - diff * float(1 - t))
        else:
            out.append(a.to(dt) + diff * float(t))
    return out


@functools.lru_cache(maxsize=8)
def _pairwise_plan(n: int):
    """The order in which numpy sums ``n`` contiguous floats: blocks of
    8192 (its buffer) one after another, each pairwise, halved (the first
    half a multiple of 8) down to leaves of at most 128 values; a leaf of
    8 or more adds 8 interleaved lanes, joins them as a tree, then adds its
    last ``m % 8`` values one by one; a shorter leaf adds all of its
    values to 0 one by one. Returns each leaf's values as indices [L, 135]
    (16 rows of 8 lanes, then 7 to add last; ``n`` where a leaf has none,
    a zero that leaves a sum unchanged), the tree's joins (node, left,
    right) by height, nodes numbered after the leaves, and each block's
    root."""
    leaves, joins = [], []

    def split(start, m):
        if m <= 128:
            row = np.full(135, n, np.int64)
            k = m - m % 8
            row[:k] = np.arange(start, start + k)
            row[128:128 + m - k] = np.arange(start + k, start + m)
            leaves.append(row)
            return ("leaf", len(leaves) - 1), 0
        half = m // 2 - m // 2 % 8
        a, ha = split(start, half)
        b, hb = split(start + half, m - half)
        joins.append((a, b, max(ha, hb) + 1))
        return ("join", len(joins) - 1), max(ha, hb) + 1

    roots = [split(s, min(8192, n - s))[0] for s in range(0, n, 8192)]

    def num(node):
        return node[1] + (len(leaves) if node[0] == "join" else 0)

    levels = []
    for h in sorted({j[2] for j in joins}):
        ids = [(len(leaves) + i, num(a), num(b))
               for i, (a, b, hj) in enumerate(joins) if hj == h]
        levels.append(torch.tensor(ids).T)
    return (torch.from_numpy(np.stack(leaves)), levels,
            [num(r) for r in roots], len(leaves) + len(joins))


def _np_sum(flat: torch.Tensor) -> torch.Tensor:
    """Each row of ``flat`` [N, n] summed in numpy's order and dtype
    (``_pairwise_plan``), so a float32 sum is numpy's to the bit."""
    n_rows, n = flat.shape
    idx, levels, roots, n_nodes = _pairwise_plan(n)
    vals = torch.cat([flat, flat.new_zeros(n_rows, 1)], 1)[
        :, idx.to(flat.device)]
    lanes = vals[..., :128].unflatten(-1, (16, 8))
    r = lanes[..., 0, :]
    for k in range(1, 16):
        r = r + lanes[..., k, :]
    leaf = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) \
        + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for k in range(128, 135):
        leaf = leaf + vals[..., k]
    nodes = torch.cat([leaf, leaf.new_zeros(n_rows, n_nodes - idx.shape[0])],
                      1)
    for level in levels:
        ids, left, right = level.to(flat.device)
        nodes[:, ids] = nodes[:, left] + nodes[:, right]
    out = flat.new_zeros(n_rows)
    for root in roots:
        out = out + nodes[:, root]
    return out


def _normalise_slices(x: torch.Tensor, scaler: str) -> torch.Tensor:
    """``pipeline/transforms.py``'s ``normalise_image`` of each [H, W]
    slice of ``x`` [N, H, W] (cast to float32 first, as there); the
    statistics are the slice's own. Robust gives float64, as there."""
    x = x.float()
    dims = (1, 2)
    scaler = scaler.lower()
    if scaler == "standard":
        n = x.shape[1] * x.shape[2]
        mean = (_np_sum(x.reshape(x.shape[0], -1)).double() / n).float()
        centred = x - mean.view(-1, 1, 1)
        var = (_np_sum((centred * centred).reshape(x.shape[0], -1)).double()
               / n).float()
        return centred / (var.sqrt().view(-1, 1, 1) + T.EPS)
    if scaler == "robust":
        ordered = x.reshape(x.shape[0], -1).sort(1).values
        n = ordered.shape[1]
        med = ordered[:, n // 2]
        if n % 2 == 0:
            med = (ordered[:, n // 2 - 1] + med) / 2
        q0, q95 = _quantiles(ordered, np.array([0.0, 0.95]))
        return (x - med.view(-1, 1, 1)).double() \
            / (q95 - q0 + T.EPS).view(-1, 1, 1)
    mn = x.amin(dims, keepdim=True)
    mx = x.amax(dims, keepdim=True)
    return (x - mn) / (mx - mn + T.EPS)


def preprocess_model_input(slices: np.ndarray, slice_spacing, cfg: Dict,
                           device="cpu") -> torch.Tensor:
    """Deterministic inference-time preprocessing of a stack of raw 2D
    slices, as one batched pass on ``device``: the stack is uploaded once
    in its stored dtype, resampled (if RESAMPLE) to the target spacing by
    ITK's linear rule in float64, x then y, and cast to float32; then per
    slice the 0.999 quantile clip, the normaliser, the centre pad/crop to
    DIM and the normaliser again, each with numpy's arithmetic. ``slices``
    is [N, y, x]; ``slice_spacing`` the in-plane (x, y) spacing shared by
    all slices. Returns the model-ready [N, H, W, 1] float32 batch on
    ``device``. The resample and the rest are one span each,
    ``serve.resample`` and ``serve.normalise`` (serving's
    ``serve.preprocess`` holds them)."""
    cfg = C.normalise_config(cfg)
    dim = tuple(C.get(cfg, "DIM"))
    target_spacing = list(reversed(C.get(cfg, "SPACING")))
    scaler = C.get(cfg, "SCALER")
    dev = torch.device(device)
    slices = np.asarray(slices)
    if slices.dtype.kind == "u" and slices.dtype.itemsize > 1:
        # torch's 16- to 64-bit unsigned dtypes lack most kernels
        slices = slices.astype(np.int64)
    x = torch.from_numpy(np.ascontiguousarray(slices)).to(dev)
    dtype = slices.dtype
    if bool(C.get(cfg, "RESAMPLE", False)):
        with span("serve.resample"):
            size = (x.shape[2], x.shape[1])
            new_size = T.calc_resampled_size(size, slice_spacing,
                                             target_spacing)
            w_dtype = x.dtype if x.is_floating_point() else torch.float64
            x = x.double()
            for k, axis in ((0, 2), (1, 1)):  # x, then y
                x = _gather_linear(x, axis, _linear_taps(
                    new_size[k], float(target_spacing[k]),
                    float(slice_spacing[k]), x.shape[axis],
                    w_dtype if k == 0 else torch.float64, dev))
            x, dtype = x.float(), np.dtype(np.float32)
    with span("serve.normalise"):
        n = x.shape[0]
        # clip_quantile: numpy takes a python-float q in a floating
        # array's dtype, and an integer array's quantile in float64
        if dtype.kind == "f":
            q = dtype.type(0.999)
        else:
            q, x = np.float64(0.999), x.double()
        top, = _quantiles(x.reshape(n, -1).sort(1).values, [q])
        x = torch.minimum(x.clamp(min=0.0), top.view(-1, 1, 1))
        x = _normalise_slices(x, scaler).float()
        (py, px), (cy, cx) = T.pad_crop_margins(x.shape[1:], dim)
        out = x.new_zeros((n, *dim))
        out[:, py[0]:dim[0] - py[1], px[0]:dim[1] - px[1]] = \
            x[:, cy[0]:x.shape[1] - cy[1], cx[0]:x.shape[2] - cx[1]]
        out = _normalise_slices(out, scaler).float()
    return out[..., None]


def pred_fold(config: Dict, device="cuda") -> bool:
    """Inference for one fold's test patients on ``device`` (ref: pred_fold,
    predict_model.py:7-201): restore the fold's model; per patient split
    the sorted slice files into ED/ES halves; per half build the inputs and
    the heatmap targets on the device in one batch (``finalize_batch``,
    K1), predict, threshold 0.5 into flat labels {1: anterior, 2:
    inferior}, keep the biggest component per label and slice (CC_FILTER,
    K2, both labels in one launch; per label in the volume with '3d', the
    3D kernel), map back to the original CMR geometry
    and write ``gt/`` and ``pred/<patient>_<ED|ES>_msk.nrrd`` and
    ``pred/<patient>_<ED|ES>_cmr.nrrd``. A HEADS model writes each head
    (``_head_outputs``), with one CC launch per head."""
    start = time.perf_counter()
    TIMING_LOG.debug("pred_fold start", extra={"timing": {"event": "start"}})
    cfg = C.normalise_config(config)
    fold = C.get(cfg, "FOLD")
    df_folds = C.get(cfg, "DF_FOLDS")
    _, _, x_val, y_val = get_trainings_files(
        data_path=C.get(cfg, "DATA_PATH_SAX"), path_to_folds_df=df_folds,
        fold=fold)

    path_to_orig = C.get(cfg, "DATA_PATH_ORIG") or ""
    orig_cmr_files = sorted(glob.glob(
        os.path.join(path_to_orig, "*/*frame[0-9][0-9].nii.gz")))
    logging.info("Found %d orig 3D CMR images", len(orig_cmr_files))

    predictor = Predictor(cfg, device=device)
    dev = predictor.device

    exp_path = C.get(cfg, "EXP_PATH")
    pred_path = os.path.join(exp_path, "pred")
    gt_path = os.path.join(exp_path, "gt")
    ensure_dir(pred_path)
    ensure_dir(gt_path)

    pred_config = dict(cfg)
    pred_config.update(SHUFFLE=False, AUGMENT=False, BATCHSIZE=1,
                       HIST_MATCHING=False)

    cc = cc_clean_fn(cfg)
    for p in fold_patients(df_folds, fold, "test"):
        files_ = filter_by_patient_id(p, x_val)
        masks_ = filter_by_patient_id(p, y_val)
        if not files_:
            continue
        half = len(files_) // 2
        splits = {"ED": (files_[:half], masks_[:half]),
                  "ES": (files_[half:], masks_[half:])}
        assert len(splits["ED"][0]) == len(splits["ED"][1]), (
            "number of images and masks should be the same")

        for phase, (phase_files, phase_masks) in splits.items():
            t0 = time.perf_counter()
            gen = DataGenerator(phase_files, phase_masks, config=pred_config)
            t1 = time.perf_counter()
            # cmrtpu finalizes one slice per call; every example is
            # normalised on its own, so one batch gives the same targets
            x, y = finalize_batch(torch.from_numpy(gen._cache_x).to(dev),
                                  torch.from_numpy(gen._cache_y).to(dev),
                                  pred_config)
            x, gts = x.cpu().numpy(), y.cpu().numpy()
            gts_cmr = x[..., 0]                                  # [z, H, W]
            t2 = time.perf_counter()
            preds = predictor.predict(x)        # [z, H, W, C] or head dict
            t3 = time.perf_counter()

            orig = None
            if orig_cmr_files:
                matches = filter_by_patient_id(p, orig_cmr_files)
                if matches:
                    orig = read_image(matches[0])
                else:
                    logging.warning(
                        "pred_fold: no original file for patient %s under "
                        "DATA_PATH_ORIG — writing this patient's outputs "
                        "on the model grid with the config-spacing header",
                        p)
            # RESAMPLE=False keeps the slices on their native in-plane
            # grid, so the header carries the slice files' own spacing
            if bool(C.get(cfg, "RESAMPLE", False)):
                inplane = tuple(reversed(C.get(cfg, "SPACING")))
            else:
                inplane = tuple(read_image(phase_files[0]).spacing[:2])
            spacing = inplane + (10.0,)

            def to_orig(arr: np.ndarray) -> MedicalImage:
                if orig is not None:
                    return undo_generator_steps(arr, cfg, R.NEAREST, orig)
                return MedicalImage(array=arr, spacing=spacing)

            cc_s = 0.0
            for suffix, preds_flat, gts_flat, label_values in \
                    _head_outputs(cfg, preds, gts):
                if cc is not None:
                    t = time.perf_counter()
                    preds_flat = cc(preds_flat, label_values,
                                    device=dev).cpu().numpy()
                    cc_s += time.perf_counter() - t
                write_image(to_orig(gts_flat.astype(np.uint8)),
                            os.path.join(gt_path, f"{p}_{phase}_{suffix}.nrrd"))
                write_image(to_orig(preds_flat.astype(np.uint8)), os.path.join(
                    pred_path, f"{p}_{phase}_{suffix}.nrrd"))
            write_image(to_orig(gts_cmr),
                        os.path.join(pred_path, f"{p}_{phase}_cmr.nrrd"))
            t4 = time.perf_counter()
            timing = {"event": "phase", "patient": p, "phase": phase,
                      "slices": len(phase_files), "load_s": t1 - t0,
                      "finalize_s": t2 - t1, "forward_s": t3 - t2,
                      "cc_s": cc_s, "write_s": t4 - t3 - cc_s,
                      "total_s": t4 - t0}
            TIMING_LOG.debug("pred_fold %s %s", p, phase,
                             extra={"timing": timing})
            logging.info("patient %s phase %s: %d slices predicted",
                         p, phase, len(phase_files))

    logging.info("done! Check %s and %s", gt_path, pred_path)
    TIMING_LOG.debug("pred_fold end", extra={"timing": {
        "event": "end", "wall_s": time.perf_counter() - start}})
    return True


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def predict_4d_on_2d_cv(exp_root: str, data_root: str,
                        export_suffix: str = "pred_4d",
                        device="cuda") -> None:
    """Run a trained 2D CV over whole 4D cine sequences on ``device``
    (ref: src/models/predict_4d_on_seg.py:23-113). Per fold ``f<k>`` of
    ``exp_root``: the ``original/*/*4d.nii.gz`` files under ``data_root``
    whose path holds one of the fold's test patients (DF_FOLDS); per file
    the t x z slices preprocessed as one batch (``preprocess_model_input``),
    one forward through ``Predictor``, the landmark head
    (``select_4d_landmark_head``) flattened into labels on the device, and
    the CC filter, which always runs (``cc_clean_fn`` or the per-slice 2D
    filter): every t of the file in one launch (K2, or the 3D kernel with
    ``CC_FILTER: '3d'``). Only the uint8 labels come back to the host; they
    are written as ``<fold>/<export_suffix>/<stem>_pred.nrrd``, [t, z, H, W]
    on the model grid (DIM), spacing (x, y) of the config with RESAMPLE and
    the study's own without, the study's z spacing, 1.0."""
    start = time.perf_counter()
    TIMING_LOG.debug("predict_4d start", extra={"timing": {
        "event": "4d_start"}})
    dev = resolve_device(device)
    fold_dirs = sorted(glob.glob(os.path.join(exp_root, "f[0-9]")))
    files_4d = sorted(glob.glob(os.path.join(data_root, "original",
                                             "*/*4d.nii.gz")))
    for fold_dir in fold_dirs:
        cfg = C.load_config(os.path.join(fold_dir, "config", "config.json"))
        cfg["MODEL_PATH"] = os.path.join(fold_dir, "model")
        test_patients = fold_patients(C.get(cfg, "DF_FOLDS"),
                                      C.get(cfg, "FOLD"), "test")
        fold_files = [f for f in files_4d
                      if any(p in f for p in test_patients)]
        predictor = Predictor(cfg, device=dev)
        out_dir = os.path.join(fold_dir, export_suffix)
        ensure_dir(out_dir)
        head_name, head_act, head_cc = select_4d_landmark_head(cfg)
        cc = cc_clean_fn(cfg) or clean_prediction_2d_cc
        dim = tuple(C.get(cfg, "DIM"))
        resample = bool(C.get(cfg, "RESAMPLE", False))
        for f4d in fold_files:
            t0 = time.perf_counter()
            vol = read_image(f4d)
            nda = vol.array  # [t, z, y, x]
            t_dim, z_dim = nda.shape[0], nda.shape[1]
            spacing = list(reversed(C.get(cfg, "SPACING"))) if resample \
                else list(vol.spacing[:2])
            t1 = time.perf_counter()
            batch = preprocess_model_input(
                nda.reshape(t_dim * z_dim, *nda.shape[2:]),
                vol.spacing[:2], cfg, device=dev)
            t2 = time.perf_counter()
            preds = predictor.predict(batch, to_host=False)
            if isinstance(preds, dict):
                preds = preds[head_name] if head_name in preds \
                    else next(iter(preds.values()))
            _sync(dev)
            t3 = time.perf_counter()
            cc_labels = head_cc
            if cc_labels is None:
                cc_labels = tuple(range(1, preds.shape[-1] + 1))
            flat = flatten_labels(preds, head_act).reshape(t_dim, z_dim, *dim)
            cleaned = cc(flat, cc_labels, device=dev).cpu().numpy()
            t4 = time.perf_counter()
            out = MedicalImage(array=cleaned.astype(np.uint8),
                               spacing=(spacing[0], spacing[1],
                                        vol.spacing[2] if vol.ndim > 2
                                        else 10.0, 1.0))
            name = os.path.basename(f4d).replace(".nii.gz", "_pred.nrrd")
            write_image(out, os.path.join(out_dir, name))
            t5 = time.perf_counter()
            TIMING_LOG.debug("predict_4d %s", name, extra={"timing": {
                "event": "4d_file", "fold": os.path.basename(fold_dir),
                "file": name, "slices": t_dim * z_dim, "read_s": t1 - t0,
                "preprocess_s": t2 - t1, "forward_s": t3 - t2,
                "cc_s": t4 - t3, "write_s": t5 - t4, "total_s": t5 - t0}})
            logging.info("4D prediction written: %s", name)
    TIMING_LOG.debug("predict_4d end", extra={"timing": {
        "event": "4d_end", "wall_s": time.perf_counter() - start}})


def predict_override_twin(exp_root: str, overrides: Dict, suffix: str,
                          device="cuda") -> str:
    """Predict every fold of a trained experiment root again, with
    predict-time config overrides, into the sibling root
    ``<exp_root>_<suffix>`` (the same checkpoints; ``pred_fold`` on
    ``device``), ready for the evaluation: any predict-time knob
    (CC_FILTER '3d', DETECTION head choices, ...) A/B'd against the plain
    root on the same weights and data. An override key that is not an
    uppercase key of ``cmrtpu_torch/config.py`` raises: the config would
    drop it silently, and the twin would equal the plain root."""
    bad = [k for k in overrides
           if not (isinstance(k, str) and k.isupper()
                   and (k in C.DEFAULTS or k in C._ALIASES
                        or k in C._SETTABLE_EXTRA))]
    if bad:
        raise ValueError(
            f"unknown override key(s) {bad} — keys must be uppercase "
            f"entries of cmrtpu_torch/config.py (DEFAULTS/_SETTABLE_EXTRA)")
    t_root = exp_root.rstrip("/") + f"_{suffix}"
    folds = sorted(glob.glob(os.path.join(exp_root, "f[0-9]*")))
    if not folds:
        raise FileNotFoundError(f"no fold dirs under {exp_root}")
    for fold_dir in folds:
        t_fold = os.path.join(t_root, os.path.basename(fold_dir))
        cfg = C.load_config(os.path.join(fold_dir, "config", "config.json"))
        cfg.update(overrides)
        cfg["EXP_PATH"] = t_fold
        cfg["MODEL_PATH"] = os.path.join(fold_dir, "model")
        ensure_dir(os.path.join(t_fold, "config"))
        with open(os.path.join(t_fold, "config", "config.json"), "w") as fh:
            json.dump(cfg, fh, indent=2, default=str)
        pred_fold(cfg, device=device)
    return t_root
