"""The explicit-collectives train step on one card (``GRAD_ALLREDUCE_DTYPE``)
— counterpart of ``cmrtpu/train/manual_collectives.py``.

cmrtpu runs this step under ``shard_map`` with per-device batches; its only
gradient collective is a ``pmean`` of every gradient cast to
``GRAD_ALLREDUCE_DTYPE`` ('bfloat16' halves the all-reduce's bytes), and
BatchNorm's batch statistics and the logs are ``pmean``'d too. On one
device each ``pmean`` is the identity, so what remains is the cast: every
gradient is rounded to that dtype and back to float32 before the optimizer
rule reads it, AGC included (AGC sits inside cmrtpu's optax chain, after
the reduction). Any other name than bfloat16 reduces in float32, the
identity. The step's histogram matching takes the batch's first rows, as
cmrtpu's does (``FusedStep`` in ``train/device_cache.py``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from cmrtpu_torch import config as C


def reduce_dtype(config: Dict) -> torch.dtype:
    """GRAD_ALLREDUCE_DTYPE as a torch dtype: bfloat16 for 'bfloat16' or
    'bf16', float32 for any other name (cmrtpu's reading)."""
    name = str(C.get(config, "GRAD_ALLREDUCE_DTYPE", "bfloat16")).lower()
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def cast_gradients_(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Round every parameter's gradient to ``dtype`` and back, in place."""
    if dtype == torch.float32:
        return
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.copy_(p.grad.to(dtype))


def make_manual_train_step(state, config: Dict) -> Callable:
    """(x, y) -> logs: ``state.train_step`` with the gradients cast to
    GRAD_ALLREDUCE_DTYPE and back before the optimizer rule."""
    dtype = reduce_dtype(config)

    def step(x: torch.Tensor, y: torch.Tensor):
        return state.train_step(
            x, y, grad_transform=lambda model: cast_gradients_(model, dtype))

    return step
