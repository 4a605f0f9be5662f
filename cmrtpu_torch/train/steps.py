"""Train state and the train/eval steps — counterpart of
``cmrtpu/train/steps.py``.

cmrtpu compiles forward, loss, backward, optimizer update and metrics into
one XLA program; here the same step runs eagerly on the card. Logs are 0-d
tensors left on the device, so an epoch syncs the host once. Dropout masks
come from the state's explicit ``torch.Generator``. BatchNorm normalises
with the batch statistics and moves its running averages in
``train_step``, and reads the running averages in ``eval_step``, as flax's
``batch_stats`` do.

Over a process group (``mesh``, ``parallel/mesh.py``) ``train_step`` is
cmrtpu's global-view step: BatchNorm takes the global batch's statistics,
the predictions and targets are gathered over the data axis, the loss and
every metric are the global batch's, the same on every rank, and one
float32 mean of the gradients over the data axis follows the backward
(the gather's backward gives each rank W times its share; the mean over
W ranks undoes it). The eval step gathers likewise; ``gather=False``
evaluates a batch every rank holds whole, with no collective.

EMA (config key ``EMA``): a float32 shadow of the parameters, moved after
each update by ``ema_update`` (two multi-tensor passes), read by the eval
step through ``torch.func.functional_call`` so the live module is never
overwritten. BatchNorm's running averages are not shadowed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from cmrtpu_torch import config as C
from cmrtpu_torch.parallel import mesh as M
from cmrtpu_torch.utils.profiling import span


def ema_decay_from_config(cfg) -> Optional[float]:
    """Config key ``EMA``: False/absent -> off; True -> decay 0.999; a
    number -> that decay."""
    ema = C.get(cfg or {}, "EMA", False)
    if not ema:
        return None
    return 0.999 if ema is True else float(ema)


def ema_update(shadow: List[torch.Tensor], params: List[torch.Tensor],
               decay: float, step: int) -> None:
    """One EMA step in place: shadow <- d*shadow + (1-d)*params, with the
    warm-up d = min(decay, (1+t)/(10+t)), t = ``step`` + 1 where ``step``
    counts the updates before this one (cmrtpu's ``ema_update``). d is
    formed in float32 as cmrtpu forms it."""
    t = np.float32(step) + np.float32(1.0)
    d = min(np.float32(decay),
            (np.float32(1.0) + t) / (np.float32(10.0) + t))
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, torch._foreach_mul(
        params, float(np.float32(1.0) - d)))


class TrainState:
    """Model, optimizer, step count and the EMA shadow, with the loss and
    metrics the steps log. ``generator`` draws the dropout masks (on the
    model's device)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable, metrics: Optional[Dict[str, Callable]],
                 generator: Optional[torch.Generator] = None,
                 config: Optional[Dict] = None,
                 mesh: Optional[M.Mesh] = None):
        self.model = model
        self.mesh = mesh or M.Mesh()
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.metrics = metrics or {}
        self.generator = generator
        self.step = 0
        self.ema_decay = ema_decay_from_config(config)
        # name -> float32 shadow, independent of the live parameters
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if self.ema_decay is not None:
            self.reset_ema()

    def reset_ema(self) -> None:
        """Seed the shadow from the live parameters (at init, and after
        weights are loaded: an init-copy shadow would blend random weights
        into early evaluations and checkpoints)."""
        self.ema = {n: p.detach().clone()
                    for n, p in self.model.named_parameters()}

    def inference_params(self) -> Dict[str, torch.Tensor]:
        """The parameters inference-time consumers read: the shadow with
        EMA on, the live ones otherwise."""
        if self.ema is not None:
            return self.ema
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def _logs(self, loss: torch.Tensor, y: torch.Tensor,
              preds: torch.Tensor) -> Dict[str, torch.Tensor]:
        logs = {"loss": loss.detach()}
        for name, fn in self.metrics.items():
            logs[name] = fn(y, preds)
        return logs

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   grad_transform: Optional[Callable[[nn.Module], None]]
                   = None, global_view: bool = True
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on (x [B, H, W, 1], y [B, H, W, C]), this
        rank's rows of the global batch. The loss and the metrics are
        computed in float32 on the pre-update predictions (a dict of them
        for a multi-head model); ``grad_transform(model)`` may change the
        gradients in place before the optimizer reads them, and replaces
        the global view's gradient mean. ``global_view`` False keeps
        BatchNorm's statistics, the loss and the logs local (the
        explicit-collectives step). The gradients stay in ``param.grad``
        until the next step. Its stages are the spans ``train.forward``,
        ``train.loss``, ``train.backward`` (REMAT's recompute among it),
        ``train.optimizer`` (with the gradient mean or transform),
        ``train.ema`` (when on) and ``train.logs``."""
        self.model.train()
        mesh = self.mesh if global_view else None
        with span("train.forward"), M.global_batch_stats(mesh):
            preds = self.model(x, generator=self.generator)
        with span("train.loss"):
            if mesh is not None and mesh.distributed:
                preds, y = (M.gather_batch(preds, mesh),
                            M.gather_batch(y, mesh))
            loss = self.loss_fn(y, preds)
        with span("train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("train.optimizer"):
            if grad_transform is not None:
                grad_transform(self.model)
            elif mesh is not None:
                M.grad_mean_(self.model, mesh)
            self.optimizer.step()
        if self.ema is not None:
            with span("train.ema"), torch.no_grad():
                ema_update(list(self.ema.values()),
                           [p.detach() for p in self.model.parameters()],
                           self.ema_decay, self.step)
        self.step += 1
        with span("train.logs"), torch.no_grad():
            return self._logs(loss, y, preds)

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor, y: torch.Tensor,
                  gather: bool = True) -> Dict[str, torch.Tensor]:
        """Loss and metrics of the eval-mode forward (no dropout, BatchNorm
        from its running averages, no update), with the EMA shadow in place
        of the parameters when EMA is on; over the global batch gathered
        from every rank's rows unless ``gather`` is False."""
        self.model.eval()
        if self.ema is not None:
            preds = torch.func.functional_call(self.model, self.ema, (x,))
        else:
            preds = self.model(x)
        if gather and self.mesh.distributed:
            preds = M.gather_batch(preds, self.mesh)
            y = M.gather_batch(y, self.mesh)
        return self._logs(self.loss_fn(y, preds), y, preds)
