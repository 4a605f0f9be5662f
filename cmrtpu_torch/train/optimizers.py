"""Optimizer factory — counterpart of ``cmrtpu/train/optimizers.py``.

Adam over ``torch.optim.Adam``: optax's ``eps`` is added outside the square
root, as torch's is, so EPSILON means the same in both packages. The
learning rate lives in the parameter groups and is read and set between
steps (ReduceLROnPlateau), as cmrtpu reads and sets its injected
hyperparameter. Other optimizers and AGC raise (ROADMAP 3.9).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from cmrtpu_torch import config as C


def get_optimizer(params: Iterable[torch.nn.Parameter],
                  config: Dict) -> torch.optim.Optimizer:
    """Adam at LEARNING_RATE with eps EPSILON (optax defaults b1 0.9,
    b2 0.999)."""
    name = str(C.get(config, "OPTIMIZER", "adam")).lower()
    if name != "adam":
        raise NotImplementedError(
            f"OPTIMIZER={name!r} is not ported to cmrtpu_torch yet (ROADMAP "
            "3.9); the port trains with adam")
    if C.get(config, "AGC", None):
        raise NotImplementedError(
            "adaptive gradient clipping (AGC) is not ported to cmrtpu_torch "
            "yet (ROADMAP 3.9)")
    return torch.optim.Adam(params,
                            lr=float(C.get(config, "LEARNING_RATE", 1e-4)),
                            betas=(0.9, 0.999),
                            eps=float(C.get(config, "EPSILON", 1e-8)))


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
