"""FLOPs of the reference Swin-Unet, counted by ``torch.utils.flop_counter``
over the benchmark's own plain model (``reference/swin_unet.py``) on the
meta device: the matrix products and convolutions of one forward, or of
one forward and its backward, at the given batch and the configuration's
DIM. The count follows from the shapes alone, so it is the same whatever
implements the layers.
"""

from __future__ import annotations

import functools
import json
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.swin_unet import Forward, param_spec


def _count(cfg: Dict, batch: int, backward: bool) -> int:
    with torch.device("meta"):
        params = {n: torch.empty(s, requires_grad=backward)
                  for n, s, _ in param_spec(cfg)}
        x = torch.empty((batch, *[int(d) for d in cfg["DIM"]],
                         int(cfg["IMG_CHANNELS"])))
        counter = FlopCounterMode(display=False)
        with counter:
            out = Forward(cfg)(params, x, train=True)
            if backward:
                out.sum().backward()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _cached(cfg_json: str, batch: int, backward: bool) -> int:
    return _count(json.loads(cfg_json), batch, backward)


def train_step_flops(cfg: Dict, batch: int) -> int:
    """Forward and backward of ``batch`` slices."""
    return _cached(json.dumps(cfg, sort_keys=True), int(batch), True)


def forward_flops(cfg: Dict, batch: int) -> int:
    """One forward of ``batch`` slices."""
    return _cached(json.dumps(cfg, sort_keys=True), int(batch), False)
