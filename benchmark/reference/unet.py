"""Plain float32 U-Net of the reference (Cardio-AI/cmr-landmark-detection,
``src/models/Unets.py`` create_unet), 2D or 3D, as a function of a
parameter dict. It imports nothing of the program under test.

Blocks, in the reference's order with BN_FIRST false:

  ConvBlock = conv 'same' -> relu -> norm (GroupNorm or BatchNorm, eps 1e-3)
  DownBlock = ConvBlock, dropout, ConvBlock, max-pool (window = stride)
  bottleneck = ConvBlock, dropout(DROPOUT_MAX), ConvBlock
  UpBlock   = nearest upsample, conv + relu, concat [up, skip], ConvBlock,
              dropout, ConvBlock
  head      = 1x1 conv, sigmoid

Parameter names follow the flax paths that the published weights carry
(``DownBlock_0.ConvBlock_1.Conv_0.weight``, ``UpBlock_2.Conv_0.bias``,
``head.weight``), kernels OIHW / OIDHW. Dropout keeps an element where
``torch.rand(shape, generator) < 1 - rate``, drawn in forward order.

``quant=torch.float8_e4m3fn`` computes every 3x3 convolution as float8
training does (the 1x1 head stays float32): input, kernel and output
rounded to e4m3 and their gradients to e5m2, each with a per-tensor
scale. ``quant=torch.int8`` rounds the same tensors and gradients to
symmetric int8 with a per-tensor scale (largest entry at 127). These are
the controls that the correctness check has to reject.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_CONV = {2: F.conv2d, 3: F.conv3d}
_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


def dims(cfg: Dict) -> Tuple[int, ...]:
    return tuple(int(d) for d in cfg["DIM"])


def effective_pools(spatial: Sequence[int], m_pool: Sequence[int],
                    depth: int) -> List[Tuple[int, ...]]:
    """Per-level pool factors; an axis that would pool below size 1 keeps
    factor 1 from then on."""
    sizes = list(spatial)
    levels = []
    for _ in range(depth):
        level = []
        for i, p in enumerate(m_pool):
            p = int(p)
            if p > 1 and sizes[i] // p >= 1:
                level.append(p)
                sizes[i] //= p
            else:
                level.append(1)
        levels.append(tuple(level))
    return levels


def dropout_rates(cfg: Dict) -> Tuple[float, ...]:
    """linspace(DROPOUT_MIN, DROPOUT_MAX, DEPTH), one decimal."""
    lin = np.linspace(cfg["DROPOUT_MIN"], cfg["DROPOUT_MAX"], cfg["DEPTH"])
    return tuple(round(float(v), 1) for v in lin)


def _groups(cfg: Dict, filters: int) -> int:
    groups = min(int(cfg["GROUP_NORM"]), filters)
    while filters % groups:
        groups -= 1
    return groups


def norm_kind(cfg: Dict) -> Optional[str]:
    if int(cfg.get("GROUP_NORM", 0) or 0):
        return "GroupNorm_0"
    if cfg.get("BATCH_NORMALISATION"):
        return "BatchNorm_0"
    return None


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind is 'kernel', 'bias',
    'scale' or 'shift'."""
    nd = len(dims(cfg))
    k = tuple(int(v) for v in cfg["F_SIZE"])[-nd:]
    f0, depth = int(cfg["FILTERS"]), int(cfg["DEPTH"])
    norm = norm_kind(cfg)
    spec = []

    def conv(prefix, cin, cout, ksize):
        spec.append((f"{prefix}.weight", (cout, cin, *ksize), "kernel"))
        spec.append((f"{prefix}.bias", (cout,), "bias"))

    def block(prefix, cin, cout):
        conv(f"{prefix}.Conv_0", cin, cout, k)
        if norm:
            spec.append((f"{prefix}.{norm}.weight", (cout,), "scale"))
            spec.append((f"{prefix}.{norm}.bias", (cout,), "shift"))

    ch = int(cfg["IMG_CHANNELS"])
    skips = []
    for level in range(depth):
        f = f0 * 2 ** level
        block(f"DownBlock_{level}.ConvBlock_0", ch, f)
        block(f"DownBlock_{level}.ConvBlock_1", f, f)
        skips.append(f)
        ch = f
    bottom = f0 * 2 ** depth
    block("ConvBlock_0", ch, bottom)
    block("ConvBlock_1", bottom, bottom)
    ch = bottom
    for i in range(depth):
        f = bottom // 2 ** (i + 1)
        conv(f"UpBlock_{i}.Conv_0", ch, f, k)
        block(f"UpBlock_{i}.ConvBlock_0", f + skips[-1 - i], f)
        block(f"UpBlock_{i}.ConvBlock_1", f, f)
        ch = f
    conv("head", ch, int(cfg["MASK_CLASSES"]), (1,) * nd)
    return spec


class _Fp8(torch.autograd.Function):
    """Float8 training's rounding: the value through e4m3 and the incoming
    gradient through e5m2, each scaled per tensor so its largest entry
    meets the format's largest finite value."""

    @staticmethod
    def forward(ctx, t):
        return _scaled(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, 57344.0)


class _Int8(torch.autograd.Function):
    """Int8 training's rounding: the value and the incoming gradient each
    to 255 levels, scaled per tensor so its largest entry is 127."""

    @staticmethod
    def forward(ctx, t):
        return _int8(t)

    @staticmethod
    def backward(ctx, g):
        return _int8(g)


def _int8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().float().clamp(min=1e-30) / 127.0
    return (torch.round(t / scale).clamp_(-127.0, 127.0) * scale).to(t.dtype)


def _scaled(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


QUANTS = {"float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8}


def _round(t: torch.Tensor, quant) -> torch.Tensor:
    """t in the lower precision ``quant`` (float8 e4m3 or int8)."""
    if quant is None:
        return t
    if quant == torch.float8_e4m3fn:
        return _Fp8.apply(t)
    if quant == torch.int8:
        return _Int8.apply(t)
    raise ValueError(f"no rounding for {quant}")


class Forward:
    """The reference forward of one configuration. ``train`` selects batch
    statistics for BatchNorm and dropout (drawn from ``generator``)."""

    def __init__(self, cfg: Dict, quant=None):
        self.cfg = cfg
        self.nd = len(dims(cfg))
        self.depth = int(cfg["DEPTH"])
        self.rates = dropout_rates(cfg)
        self.drop_bottom = float(cfg["DROPOUT_MAX"])
        self.norm = norm_kind(cfg)
        self.quant = quant
        self.pools = effective_pools(
            dims(cfg), tuple(int(v) for v in cfg["M_POOL"])[-self.nd:],
            self.depth)

    def _conv(self, p, name, x, head=False):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if head or self.quant is None:
            return _CONV[self.nd](x, w, b, padding="same")
        y = _CONV[self.nd](_round(x, self.quant), _round(w, self.quant),
                           padding="same")
        return _round(_round(y, self.quant)
                      + _round(b, self.quant).reshape(1, -1, *[1] * self.nd),
                      self.quant)

    def _norm(self, p, prefix, x, train):
        if self.norm is None:
            return x
        w = p[f"{prefix}.{self.norm}.weight"]
        b = p[f"{prefix}.{self.norm}.bias"]
        if self.norm == "GroupNorm_0":
            return F.group_norm(x, _groups(self.cfg, x.shape[1]), w, b,
                                eps=1e-3)
        if not train:
            raise ValueError("the reference's BatchNorm runs in train mode "
                             "only")
        red = (0, *range(2, x.dim()))
        mean = x.mean(dim=red)
        var = torch.clamp(x.square().mean(dim=red) - mean.square(), min=0.0)
        shape = (1, -1, *[1] * self.nd)
        mul = torch.rsqrt(var + 1e-3) * w
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + b.reshape(shape)

    def _block(self, p, prefix, x, train):
        return self._norm(p, prefix, F.relu(self._conv(p, f"{prefix}.Conv_0",
                                                       x)), train)

    def _dropout(self, x, rate, generator):
        if generator is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 train: bool = True,
                 generator: Optional[torch.Generator] = None,
                 logits: bool = False) -> torch.Tensor:
        """x [N, *DIM, C] -> probabilities [N, *DIM, classes] (or the head's
        logits). Dropout only with a ``generator``."""
        h = torch.movedim(x, -1, 1).float()
        skips = []
        for level in range(self.depth):
            pre = f"DownBlock_{level}"
            h = self._block(p, f"{pre}.ConvBlock_0", h, train)
            h = self._dropout(h, self.rates[level], generator)
            h = self._block(p, f"{pre}.ConvBlock_1", h, train)
            skips.append(h)
            pool = self.pools[level]
            h = _POOL[self.nd](h, pool, stride=pool)
        h = self._block(p, "ConvBlock_0", h, train)
        h = self._dropout(h, self.drop_bottom, generator)
        h = self._block(p, "ConvBlock_1", h, train)
        ups = self.pools[::-1]
        rates = self.rates[::-1]
        for i in range(self.depth):
            pre = f"UpBlock_{i}"
            for axis, f in enumerate(ups[i], start=2):
                if f != 1:
                    h = h.repeat_interleave(int(f), dim=axis)
            h = F.relu(self._conv(p, f"{pre}.Conv_0", h))
            h = torch.cat([h, skips.pop()], dim=1)
            h = self._block(p, f"{pre}.ConvBlock_0", h, train)
            h = self._dropout(h, rates[i], generator)
            h = self._block(p, f"{pre}.ConvBlock_1", h, train)
        out = self._conv(p, "head", h, head=True)
        if not logits:
            out = torch.sigmoid(out)
        return torch.movedim(out, 1, -1)
