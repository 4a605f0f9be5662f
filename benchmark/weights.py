"""Seeded weights of a configuration, made on the device in a few large
calls: one normal draw for every kernel element, truncated at two standard
deviations and scaled by each kernel's he_normal deviation
(sqrt(2 / fan_in) / 0.8796), zero biases, unit norm scales. The same dict
goes to the program and to the reference.

Streams: the program's training loop draws dropout from SEED and its
augmentation from SEED + 1; the weights take SEED + 2 and the traffic
generator SEED + 3, so no two streams start from the same state.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from benchmark.reference.unet import param_spec

WEIGHT_STREAM = 2


def make_weights(cfg: Dict, seed: int, device,
                 head_bias_prob: Optional[Sequence[float]] = None
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``. ``head_bias_prob`` sets each
    head channel's bias to logit(p), so that channel marks about a share
    p of the pixels."""
    spec = param_spec(cfg)
    kernels = [(n, s) for n, s, k in spec if k == "kernel"]
    sizes = [math.prod(s) for _, s in kernels]
    stds = torch.tensor([math.sqrt(2.0 / math.prod(s[1:])) / 0.87962566103423978
                         for _, s in kernels], device=device)
    g = torch.Generator(device).manual_seed(seed + WEIGHT_STREAM)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat = flat.clamp_(-2.0, 2.0).mul_(
        stds.repeat_interleave(torch.tensor(sizes, device=device)))
    out = dict(zip((n for n, _ in kernels),
                   (t.reshape(s) for t, (_, s) in zip(flat.split(sizes),
                                                     kernels))))
    for name, shape, kind in spec:
        if kind == "scale":
            out[name] = torch.ones(shape, device=device)
        elif kind in ("bias", "shift"):
            out[name] = torch.zeros(shape, device=device)
    if head_bias_prob is not None:
        out["head.bias"].copy_(torch.tensor(
            [math.log(p / (1.0 - p)) for p in head_bias_prob],
            device=device))
    return out
