"""Train state and the train/eval steps — counterpart of
``cmrtpu/train/steps.py``.

cmrtpu compiles forward, loss, backward, optimizer update and metrics into
one XLA program; here the same step runs eagerly on the card. Logs are 0-d
tensors left on the device, so an epoch syncs the host once. Dropout masks
come from the state's explicit ``torch.Generator``. BatchNorm normalises
with the batch statistics and moves its running averages in
``train_step``, and reads the running averages in ``eval_step``, as flax's
``batch_stats`` do. Not ported: EMA (ROADMAP 3.3), which raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from cmrtpu_torch import config as C


class TrainState:
    """Model, optimizer and step count, with the loss and metrics the steps
    log. ``generator`` draws the dropout masks (on the model's device)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable, metrics: Optional[Dict[str, Callable]],
                 generator: Optional[torch.Generator] = None,
                 config: Optional[Dict] = None):
        if C.get(config or {}, "EMA", False):
            raise NotImplementedError(
                "the EMA shadow of the parameters (EMA) is not ported to "
                "cmrtpu_torch yet (ROADMAP 3.3)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.metrics = metrics or {}
        self.generator = generator
        self.step = 0

    def _logs(self, loss: torch.Tensor, y: torch.Tensor,
              preds: torch.Tensor) -> Dict[str, torch.Tensor]:
        logs = {"loss": loss.detach()}
        for name, fn in self.metrics.items():
            logs[name] = fn(y, preds)
        return logs

    def train_step(self, x: torch.Tensor,
                   y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimizer step on (x [B, H, W, 1], y [B, H, W, C]). The loss
        and the metrics are computed in float32 on the pre-update
        predictions (a dict of them for a multi-head model); the gradients
        stay in ``param.grad`` until the next step."""
        self.model.train()
        preds = self.model(x, generator=self.generator)
        loss = self.loss_fn(y, preds)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            return self._logs(loss, y, preds)

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Loss and metrics of the eval-mode forward (no dropout, BatchNorm
        from its running averages, no update)."""
        self.model.eval()
        preds = self.model(x)
        return self._logs(self.loss_fn(y, preds), y, preds)
