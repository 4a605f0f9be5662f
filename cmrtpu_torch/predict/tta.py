"""Rot90-orbit test-time augmentation (TTA) — counterpart of
``cmrtpu/predict/tta.py``.

The reference trains with RandomRotate90 augmentation but serves one
forward. With ``TTA: true`` the served forward runs the model on each
rotation of the orbit, rotates the outputs back and combines them:
``TTA_MODE: 'probs'`` averages the probability maps (leaf-wise for a
HEADS model's dict), ``'coords'`` averages the landmark coordinates and
passes the identity forward through wherever it is confirmed (see
``tta_rot90_coords_forward``). A bare ``TTA: true`` means 'probs', as in
cmrtpu, so one config computes the same function in both packages; on a
converged run 'coords' is the combiner that cannot degrade it (ROADMAP
Queue 3).

Every forward here takes and returns the public layout [N, ..., H, W, C]
(the in-plane axes are the last-but-one pair) on the input's device; the
K forwards run one after another on the card, each the model's own.
``tta_forward_from_config`` is the one dispatch that ``Predictor``,
``EnsemblePredictor`` and ``export_model`` use.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from cmrtpu_torch import config as C

_PLANE = (-3, -2)


def rot90_orbit(dim: Sequence[int]) -> tuple:
    """The shape-preserving rot90 multiples for a spatial DIM: the whole
    orbit (0, 1, 2, 3) for a square plane, else only (0, 2): 90 and 270
    degrees would swap H and W."""
    return (0, 1, 2, 3) if dim[-1] == dim[-2] else (0, 2)


def predict_tta_twin(exp_root: str, mode: str = "probs",
                     device="cuda") -> str:
    """Predict every fold of a trained experiment root again with ``TTA:
    true`` and ``TTA_MODE: mode`` into the sibling root
    ``<exp_root>_tta_<mode>`` (the same checkpoints; ``pred_fold`` on
    ``device``). Returns the twin root, ready for the evaluation."""
    from cmrtpu_torch.predict.predictor import predict_override_twin

    return predict_override_twin(exp_root, {"TTA": True, "TTA_MODE": mode},
                                 f"tta_{mode}", device=device)


def _rotate(out, k: int):
    """rot90 by ``k`` in the plane of a tensor or of each head's tensor."""
    if isinstance(out, dict):
        return {name: torch.rot90(v, k, _PLANE) for name, v in out.items()}
    return torch.rot90(out, k, _PLANE)


def tta_rot90_forward(forward: Callable, dim: Sequence[int]) -> Callable:
    """``forward(x) -> outputs`` averaged over the rot90 orbit of ``x``'s
    plane: each rotation's output rotated back, then the mean of the K
    outputs (summed in orbit order, as cmrtpu's ``sum(leaves) / K``);
    a dict output is averaged head by head."""
    ks = rot90_orbit(dim)

    def tta(x: torch.Tensor):
        outs = [_rotate(forward(torch.rot90(x, k, _PLANE)), -k) for k in ks]
        if isinstance(outs[0], dict):
            return {name: sum(o[name] for o in outs) / len(outs)
                    for name in outs[0]}
        return sum(outs) / len(outs)

    return tta


def _com_coords(prob: torch.Tensor):
    """Per-channel thresholded centre of mass over the plane of [..., H, W,
    C] probabilities: (coords [..., C, 2] as (y, x) pixels, valid [..., C]
    where any pixel crossed 0.5) — the binary CoM the evaluation scores."""
    b = (prob > 0.5).float()
    h, w = prob.shape[-3], prob.shape[-2]
    iy = torch.arange(h, dtype=torch.float32, device=prob.device)[:, None,
                                                                   None]
    ix = torch.arange(w, dtype=torch.float32, device=prob.device)[None, :,
                                                                   None]
    cnt = b.sum(dim=_PLANE)
    sy = (b * iy).sum(dim=_PLANE)
    sx = (b * ix).sum(dim=_PLANE)
    safe = torch.clamp(cnt, min=1.0)
    return torch.stack([sy / safe, sx / safe], dim=-1), cnt > 0


def tta_rot90_coords_forward(forward: Callable,
                             dim: Sequence[int]) -> Callable:
    """Coordinate-space TTA (``TTA_MODE: 'coords'``, cmrtpu's
    ``tta_rot90_coords_forward``). Each orbit member's per-channel
    thresholded CoM is taken in its own frame after rotating its output
    back; per (slice, channel):

      * detected = a majority (>= ceil(K / 2)) of the members cross 0.5;
      * the identity member detects and the majority confirms: its raw
        probability map passes through untouched;
      * the identity misses but the majority detects: a 3 x 3 stamp of 1.0
        at the valid members' mean coordinate, rounded half to even;
      * the identity detects but the majority does not: zero.

    A dict (HEADS) output raises: coordinate averaging is a landmark-head
    semantic."""
    ks = rot90_orbit(dim)
    majority = (len(ks) + 1) // 2

    def tta(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        coords_k, valid_k = [], []
        identity_map = None
        for k in ks:
            out = forward(torch.rot90(x, k, _PLANE))
            if isinstance(out, dict):
                raise TypeError(
                    "TTA_MODE='coords' supports single-output (landmark-"
                    "head) models only; multi-head models need "
                    "TTA_MODE='probs'")
            out = torch.rot90(out, -k, _PLANE)
            if k == 0:
                identity_map = out
            coords, valid = _com_coords(out)
            coords_k.append(coords)
            valid_k.append(valid)
        coords = torch.stack(coords_k)                   # [K, ..., C, 2]
        valid = torch.stack(valid_k).float()             # [K, ..., C]
        n_valid = valid.sum(dim=0)                       # [..., C]
        mean = ((coords * valid[..., None]).sum(dim=0)
                / torch.clamp(n_valid, min=1.0)[..., None])
        detected = n_valid >= majority                   # [..., C]
        anchored = (valid[0] > 0) & detected

        my = torch.round(mean[..., 0])[..., None, None, :]  # [..., 1, 1, C]
        mx = torch.round(mean[..., 1])[..., None, None, :]
        yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None,
                                                                   None]
        xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :,
                                                                   None]
        blob = ((yy - my).abs() <= 1) & ((xx - mx).abs() <= 1)
        stamp = (blob & detected[..., None, None, :]).float()
        return torch.where(anchored[..., None, None, :],
                           identity_map.float(), stamp)

    return tta


def tta_forward_from_config(forward: Callable, config: Dict) -> Callable:
    """The one TTA dispatch (``Predictor``, ``EnsemblePredictor``,
    ``export_model``): ``TTA_MODE`` 'probs' (the default, as in cmrtpu) or
    'coords'; 'coords' with HEADS and any other mode raise."""
    dim = tuple(C.get(config, "DIM"))
    mode = str(C.get(config, "TTA_MODE", "probs") or "probs").lower()
    if mode in ("probs", "prob"):
        return tta_rot90_forward(forward, dim)
    if mode in ("coords", "coord"):
        if C.get(config, "HEADS", ()) or ():
            raise ValueError(
                "TTA_MODE='coords' is a landmark-head semantic and does not "
                "support multi-head (HEADS) models — use TTA_MODE='probs'")
        return tta_rot90_coords_forward(forward, dim)
    raise ValueError(f"TTA_MODE={mode!r}: expected 'probs' or 'coords'")
