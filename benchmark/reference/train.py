"""The reference's first training steps in plain float32 PyTorch: gather,
augmentation, heatmap targets, U-Net forward with dropout, BCE + Dice loss,
backward and optax's Adam, one step after the other on the same rows the
program trained on. It imports nothing of the program.

Draws: the augmentation comes from a generator seeded SEED + 1 and the
dropout masks from one seeded SEED, both on the device, as the configured
training loop documents its streams, so the reference sees the same warps
and masks when it draws the same shapes in the same order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import augment as A
from benchmark.reference.unet import Forward

KERAS_EPS = 1e-7
SMOOTH = 1.0


def bce_dice_loss(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """mean keras binary cross-entropy minus the smoothed soft Dice."""
    q = torch.clamp(p, KERAS_EPS, 1.0 - KERAS_EPS)
    bce = -(y * torch.log(q + KERAS_EPS)
            + (1.0 - y) * torch.log(1.0 - q + KERAS_EPS))
    yt, yp = y.reshape(-1), p.reshape(-1)
    dice = (2.0 * torch.sum(yt * yp) + SMOOTH) / (torch.sum(yt)
                                                  + torch.sum(yp) + SMOOTH)
    return bce.mean() - dice


class Adam:
    """optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8) on a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 eps: float = 1e-8):
        self.lr, self.eps, self.t = float(lr), float(eps), 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - float(np.float32(0.9)) ** self.t
        bc2 = 1.0 - float(np.float32(0.999)) ** self.t
        for k, g in grads.items():
            self.mu[k].mul_(0.9).add_(g, alpha=0.1)
            self.nu[k].mul_(0.999).addcmul_(g, g, value=0.001)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps)
            params[k].sub_(self.lr * upd)


def run_steps(cfg: Dict, seed: int, weights: Dict[str, torch.Tensor],
              data_x: torch.Tensor, data_y: torch.Tensor,
              rows: np.ndarray, quant=None) -> Dict:
    """``len(rows)`` training steps from ``weights`` over the cache
    (data_x [N, *DIM] float32, data_y [N, *DIM] labels) on its device.
    Returns each step's loss, the first step's gradient and the
    parameters' change after the last step, leaf by leaf."""
    dev = data_x.device
    fwd = Forward(cfg, quant=quant)
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = Adam(params, cfg["LEARNING_RATE"], cfg.get("EPSILON", 1e-8))
    aug_g = torch.Generator(dev).manual_seed(seed + 1)
    drop_g = torch.Generator(dev).manual_seed(seed)
    batch = int(cfg["BATCHSIZE"])
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for step, ids in enumerate(rows):
        idx = torch.as_tensor(np.asarray(ids), device=dev)
        imgs = data_x.index_select(0, idx).float()
        msks = data_y.index_select(0, idx).float()
        if cfg.get("AUGMENT"):
            imgs, msks = A.apply_params(A.draw_params(aug_g, cfg, batch),
                                        imgs, msks)
        x, y = A.targets(imgs, msks, cfg)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = bce_dice_loss(y, fwd(leaves, x, train=True, generator=drop_g))
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        for v in params.values():
            v.requires_grad_(False)
        if step == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    change = {k: params[k] - weights[k].float() for k in params}
    return {"loss": losses, "grad": first, "change": change}
