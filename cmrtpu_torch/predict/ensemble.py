"""Cross-validation ensemble inference and the uniform model soup —
counterpart of ``cmrtpu/predict/ensemble.py``.

All fold models of a CV root share one architecture, so their parameters
and buffers stack along a leading member axis
(``torch.func.stack_module_state``) and ONE ``vmap`` of
``functional_call`` over that axis evaluates every member on the same
batch: the convolutions see the member axis as a batch of weights, not K
calls. The members' probabilities are averaged on the device (head by head
for a HEADS model). ``soup`` collapses the members into one set of weights
(the float64 mean, dtype kept), and ``soup_experiment`` predicts a CV root's
folds with it.

With int8 members (``QUANT_INT8``) the vmap runs too, but ``torch._int_mm``
has no batching rule: torch warns and runs it once per member.
"""

from __future__ import annotations

import copy
import glob
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from cmrtpu_torch import config as C
from cmrtpu_torch.predict.predictor import (_supervised, pred_fold,
                                            resolve_device, to_numpy)
from cmrtpu_torch.train.checkpoint import (load_weights_for_model,
                                           save_weights)
from cmrtpu_torch.utils.io_utils import ensure_dir


class _BatchedGroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` that ``vmap`` can batch: ``F.group_norm`` asks its
    input for its memory format, which a vmapped tensor cannot answer, so
    this calls the op it dispatches to, ``native_group_norm``, on the
    contiguous input, as ``F.group_norm`` does for an NCHW tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        return torch.native_group_norm(
            x.contiguous(), self.weight, self.bias, n, c,
            x[0, 0].numel(), self.num_groups, self.eps)[0]


def _member_code(model: nn.Module) -> nn.Module:
    """A copy of ``model`` on the meta device (its tensors come from
    ``functional_call``), with every GroupNorm made batchable."""
    base = copy.deepcopy(model).to("meta")
    for mod in base.modules():
        if type(mod) is nn.GroupNorm:
            mod.__class__ = _BatchedGroupNorm
    return base


def _mean_over_members(out):
    """The mean over the leading member axis of a tensor or of each head's
    tensor."""
    if isinstance(out, dict):
        return {name: v.mean(dim=0) for name, v in out.items()}
    return out.mean(dim=0)


class EnsemblePredictor:
    """Average-probability ensemble over fold checkpoints on ``device``.

    >>> ens = EnsemblePredictor.from_exp_root("exp/rvip/2026-01-01_00_00")
    >>> probs = ens.predict(x)            # [B, H, W, C] mean over members
    """

    def __init__(self, config: Dict, weight_dirs: Sequence[str],
                 device="cuda"):
        from cmrtpu_torch.models.hybrids import get_model

        if not weight_dirs:
            raise ValueError("no fold checkpoints given")
        self.config = C.normalise_config(config)
        self.device = resolve_device(device)
        flags = {_supervised(d) for d in weight_dirs}
        if len(flags) != 1:
            raise ValueError("the members disagree on deep supervision: "
                             f"{list(weight_dirs)}")
        (supervision,) = flags
        members = [load_weights_for_model(
            d, get_model(self.config, supervision=supervision), self.config
        ).to(self.device).eval() for d in weight_dirs]
        self.n_members = len(members)
        self._params, self._buffers = stack_module_state(members)
        self._base = _member_code(members[0])

        def member_forward(params, buffers, x):
            return functional_call(self._base, (params, buffers), (x,))

        self._members = vmap(member_forward, in_dims=(0, 0, None))

        def ensemble_forward(x):
            return _mean_over_members(
                self._members(self._params, self._buffers, x))

        self._apply = ensemble_forward
        if C.get(self.config, "TTA", False):
            # 'probs' averaging is linear, so the orbit of the member mean
            # is the member mean of the orbits; with 'coords' the members
            # are averaged in probability space first, as in cmrtpu
            from cmrtpu_torch.predict.tta import tta_forward_from_config
            self._apply = tta_forward_from_config(ensemble_forward,
                                                  self.config)

    @classmethod
    def from_exp_root(cls, exp_root: str, config: Optional[Dict] = None,
                      device="cuda") -> "EnsemblePredictor":
        """Every ``f<k>/model`` with a ``model.npz`` under a timestamped
        experiment root (the layout ``train_fold`` writes); the config is
        the first fold's unless given."""
        fold_models = sorted(glob.glob(os.path.join(exp_root, "f[0-9]*",
                                                    "model")))
        fold_models = [d for d in fold_models
                       if os.path.exists(os.path.join(d, "model.npz"))]
        if config is None:
            cfg_files = sorted(glob.glob(os.path.join(
                exp_root, "f[0-9]*", "config", "config.json")))
            if not cfg_files:
                raise FileNotFoundError(f"no fold configs under {exp_root}")
            config = C.load_config(cfg_files[0])
        return cls(config, fold_models, device=device)

    @torch.inference_mode()
    def _forward(self, x):
        """[B, ..., C] float32 (an array, or a tensor, which is used where
        it lies on the device) -> the member mean (a dict per head for a
        HEADS model), left on the device."""
        return self._apply(torch.as_tensor(x, device=self.device))

    def predict(self, x: np.ndarray):
        """Mean member probability for a [B, ...] batch on the host: [B,
        ..., C], or a dict of per-head arrays."""
        return to_numpy(self._forward(x), x.shape[0])

    @torch.inference_mode()
    def predict_members(self, x: np.ndarray):
        """Per-member probabilities [K, B, ...] on the host (a dict of them
        for a HEADS model)."""
        out = self._members(self._params, self._buffers,
                            torch.as_tensor(x, device=self.device))
        return to_numpy(out, self.n_members)

    def soup(self) -> Dict[str, torch.Tensor]:
        """The uniform model soup (Wortsman et al., arXiv:2203.05482): one
        state_dict whose every tensor is the float64 mean of the members',
        cast back to its dtype, on the host. int8 members raise: averaging
        int8 grids is not a model (cmrtpu averages them; ROADMAP Queue
        3)."""
        if C.get(self.config, "QUANT_INT8", False):
            raise ValueError("cannot soup int8 twins — soup the float root, "
                             "then quantize the soup")
        out = {}
        for name, stacked in {**self._params, **self._buffers}.items():
            a = stacked.detach().cpu().numpy()
            out[name] = torch.from_numpy(np.ascontiguousarray(
                np.mean(a.astype(np.float64), axis=0).astype(a.dtype)))
        return out


def soup_experiment(exp_root: str, out_root: Optional[str] = None,
                    device="cuda") -> str:
    """The uniform soup of a CV root's folds as a sibling experiment root
    (``<exp_root>_soup``): the averaged weights written once to
    ``<root>_soup/model``, each ``f<k>`` twin keeping its own config (so
    its own test split) with MODEL_PATH at the soup, and every fold's
    ``pred_fold`` run on ``device``. Float checkpoints only."""
    folds = sorted(glob.glob(os.path.join(exp_root, "f[0-9]*")))
    folds = [f for f in folds
             if os.path.exists(os.path.join(f, "model", "model.npz"))]
    if not folds:
        raise FileNotFoundError(f"no trained fold dirs under {exp_root}")
    cfg0 = C.load_config(os.path.join(folds[0], "config", "config.json"))
    if C.get(cfg0, "QUANT_INT8", False):
        raise ValueError("cannot soup int8 twins — soup the float root, "
                         "then quantize the soup")
    ens = EnsemblePredictor(cfg0, [os.path.join(f, "model") for f in folds],
                            device=device)
    out_root = out_root or exp_root.rstrip("/") + "_soup"
    soup_model = os.path.join(out_root, "model")
    save_weights(soup_model, ens.soup())
    for fold_dir in folds:
        t_fold = os.path.join(out_root, os.path.basename(fold_dir))
        cfg = C.load_config(os.path.join(fold_dir, "config", "config.json"))
        cfg["EXP_PATH"] = t_fold
        cfg["MODEL_PATH"] = soup_model
        ensure_dir(os.path.join(t_fold, "config"))
        with open(os.path.join(t_fold, "config", "config.json"), "w") as fh:
            json.dump(cfg, fh, indent=2, default=str)
        pred_fold(cfg, device=device)
    return out_root
