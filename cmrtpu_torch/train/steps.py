"""Train state and the train/eval steps — counterpart of
``cmrtpu/train/steps.py``.

cmrtpu compiles forward, loss, backward, optimizer update and metrics into
one XLA program; here the same step runs eagerly on the card. Logs are 0-d
tensors left on the device, so an epoch syncs the host once. Dropout masks
come from the state's explicit ``torch.Generator``. Not ported: EMA (ROADMAP
3.3) and BatchNorm in train mode (ROADMAP 2.6), which both raise.
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
        if any(isinstance(m, nn.modules.batchnorm._BatchNorm)
               for m in model.modules()):
            raise NotImplementedError(
                "BatchNorm in train mode (GROUP_NORM: 0) is not ported to "
                "cmrtpu_torch yet (ROADMAP 2.6: flax's running averages use "
                "momentum 0.99 and the biased batch variance, torch's the "
                "unbiased one); train with GROUP_NORM")
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
        predictions; the gradients stay in ``param.grad`` until the next
        step."""
        self.model.train()
        preds = self.model(x, generator=self.generator)
        loss = self.loss_fn(y, preds)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            return self._logs(loss, y, preds.detach())

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Loss and metrics of the eval-mode forward (no dropout, no
        update)."""
        self.model.eval()
        preds = self.model(x)
        return self._logs(self.loss_fn(y, preds), y, preds)
