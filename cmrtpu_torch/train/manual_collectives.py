"""The explicit-collectives train step (``GRAD_ALLREDUCE_DTYPE``) —
counterpart of ``cmrtpu/train/manual_collectives.py``.

cmrtpu runs this step under ``shard_map`` with per-device batches. Here
each rank runs it on its rows:
  * BatchNorm's batch statistics are the rank's own, and the optimized
    objective is the mean of the per-rank losses (dice is not shard-linear,
    so this differs from the global-view step, as keras' MirroredStrategy
    does);
  * every gradient is cast to ``GRAD_ALLREDUCE_DTYPE`` ('bfloat16' halves
    the all-reduce's bytes), summed over the ranks in that dtype, divided
    by W and cast back to float32 before the optimizer rule reads it, AGC
    included (AGC sits inside cmrtpu's optax chain, after the reduction):
    one all-reduce a step;
  * BatchNorm's running averages and the logs are then averaged over the
    ranks, one all-reduce each.
Without a process group every mean is the identity and only the cast
remains. Any other dtype name than bfloat16 reduces in float32. The step's
histogram matching takes the first rows of the rank's batch against its
own cache, as cmrtpu's does (``FusedStep`` in ``train/device_cache.py``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.parallel import mesh as M


def reduce_dtype(config: Dict) -> torch.dtype:
    """GRAD_ALLREDUCE_DTYPE as a torch dtype: bfloat16 for 'bfloat16' or
    'bf16', float32 for any other name (cmrtpu's reading)."""
    name = str(C.get(config, "GRAD_ALLREDUCE_DTYPE", "bfloat16")).lower()
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def make_manual_train_step(state, config: Dict) -> Callable:
    """(x, y) -> logs: ``state.train_step`` on the rank's rows with local
    BatchNorm statistics and loss, the gradients' mean over the ranks in
    GRAD_ALLREDUCE_DTYPE, then the BatchNorm running averages and the logs
    averaged over the ranks."""
    dtype = reduce_dtype(config)
    mesh = state.mesh

    def step(x: torch.Tensor, y: torch.Tensor):
        logs = state.train_step(
            x, y, grad_transform=lambda model: M.grad_mean_(model, mesh,
                                                            dtype),
            global_view=False)
        if not mesh.distributed:
            return logs
        buffers = [b for name, b in state.model.named_buffers()
                   if name.endswith(("running_mean", "running_var"))]
        if buffers:
            with torch.no_grad():
                torch._foreach_copy_(buffers, M.mean_over_ranks(
                    buffers, mesh, "batch_stats_mean"))
        keys = list(logs)
        means = M.mean_over_ranks([logs[k] for k in keys], mesh, "logs_mean")
        return dict(zip(keys, means))

    return step
