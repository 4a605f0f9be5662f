"""2D U-Net as torch ``nn.Module``s — counterpart of ``cmrtpu/models/unet.py``.

Same blocks, same order, same parameter tree:

  * ConvBlock  = Conv -> norm -> act (BN_FIRST) or Conv+act -> norm
  * DownBlock  = ConvBlock, Dropout, ConvBlock, MaxPool (VALID, window = stride)
  * UpBlock    = nearest Upsample + Conv+act, Concat([up, skip]), ConvBlock,
                 Dropout, ConvBlock
  * UNet       = depth x DownBlock, bottleneck ConvBlock-Dropout-ConvBlock,
                 depth x UpBlock, 1x1 f32 head + sigmoid

Submodules carry the flax auto-names (``DownBlock_0/ConvBlock_1/Conv_0`` and
so on), so a ``state_dict`` key is the flax path with ``/`` -> ``.`` and the
weights bridge (``cmrtpu_torch/train/checkpoint.py``) is a rename plus an
HWIO -> OIHW transpose.

Public layout follows the JAX package: ``UNet.forward`` takes ``[N, H, W, C]``
and returns ``[N, H, W, classes]`` probabilities; inside, tensors are NCHW.
Under ``MIXED_PRECISION`` the convs run in bf16 on f32 parameters, the norms
and the head in f32, as in the reference.

Ported: the plain 2D U-Net with GroupNorm, eval-mode BatchNorm or no norm,
and the upsample decoder. In train mode dropout draws its masks from an
explicit ``torch.Generator`` passed to ``forward`` (flax draws them from the
step's dropout key); train-mode BatchNorm is not ported (the train state
raises, ROADMAP 2.6). Every other configuration raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmrtpu_torch import config as C

_ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    # flax's nn.gelu is the tanh approximation by default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
}


def effective_pools(spatial: Sequence[int], m_pool: Sequence[int],
                    depth: int) -> Tuple[Tuple[Tuple[int, ...], ...], bool]:
    """Per-level pool factors with exhausted axes clamped to 1 (see
    ``cmrtpu.models.unet.effective_pools``). Returns (pools_per_level,
    clamped_any)."""
    dims = list(spatial)
    pools = []
    clamped = False
    for _ in range(depth):
        level = []
        for i, p in enumerate(m_pool):
            p = int(p)
            if p > 1 and dims[i] // p >= 1:
                level.append(p)
                dims[i] //= p
            else:
                level.append(1)
                clamped = clamped or p > 1
        pools.append(tuple(level))
    return tuple(pools), clamped


def apply_softcap(logits: torch.Tensor, softcap) -> torch.Tensor:
    """tanh soft cap on head logits: logits <- cap * tanh(logits / cap).
    Falsy and non-positive values mean disabled, as in the reference."""
    if not softcap:
        return logits
    cap = float(softcap)
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``he_normal``: variance_scaling(2.0, 'fan_in', 'truncated_normal'),
    a normal truncated at two standard deviations and rescaled so the
    truncated distribution has variance 2 / fan_in. ``weight`` is OIHW."""
    fan_in = weight[0].numel()
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of norms, head and loss: float32 under bf16 or f32
    compute, as in the reference; float64 for a float64 model (a reference
    evaluation of the same math)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)`` on f32 params: input, kernel and bias are
    cast to the compute dtype; 'SAME' padding. The bias is added after the
    convolution's output is rounded to ``dtype``, where flax adds it: folding
    it into the bf16 convolution rounds once instead of twice, and the
    difference grows to 0.1 in probability through a depth-3 GroupNorm net."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding="same")
    return y + conv.bias.to(dtype)[:, None, None]


def _dropout(x: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode keep each element with probability
    1 - rate and scale it by 1 / (1 - rate), in the input's dtype; the mask
    comes from ``generator``, never from torch's global generator."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit "
                         "torch.Generator (forward(x, generator=...))")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _upsample_nearest(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour upsampling of NCHW by integer factors per axis."""
    for axis, f in enumerate(factors, start=2):
        if f != 1:
            x = x.repeat_interleave(int(f), dim=axis)
    return x


class ConvBlock(nn.Module):
    """Conv + norm + activation with the reference's ordering switch.

    ``group_norm=N`` uses GroupNorm with min(N, filters) groups, reduced
    until it divides ``filters``; otherwise BatchNorm when ``batch_norm``.
    Both use epsilon 1e-3 and run in f32; the block output is cast to
    ``dtype``."""

    def __init__(self, in_ch: int, filters: int, f_size: Tuple[int, int],
                 activation: str = "relu", batch_norm: bool = True,
                 bn_first: bool = False, group_norm: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.bn_first = bn_first
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_ch, filters, tuple(f_size), padding="same")
        self.norm_name: Optional[str] = None
        if group_norm:
            groups = min(int(group_norm), filters)
            while filters % groups:  # GroupNorm needs groups | channels
                groups -= 1
            self.norm_name = "GroupNorm_0"
            self.GroupNorm_0 = nn.GroupNorm(groups, filters, eps=1e-3)
        elif batch_norm:
            # flax momentum 0.99 on the running average == torch momentum 0.01
            self.norm_name = "BatchNorm_0"
            self.BatchNorm_0 = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)

    def _norm(self, y: torch.Tensor) -> torch.Tensor:
        if self.norm_name is None:
            return y
        return getattr(self, self.norm_name)(y.to(wide_dtype(self.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn_first:
            x = self.act(self._norm(_conv(self.Conv_0, x, self.dtype)))
        else:
            x = self._norm(self.act(_conv(self.Conv_0, x, self.dtype)))
        return x.to(self.dtype)


class DownBlock(nn.Module):
    """conv-drop-conv + max-pool; returns (skip, pooled)."""

    def __init__(self, in_ch: int, filters: int, drop: float, **kw):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_ch, filters, **kw)
        self.drop = drop
        self.ConvBlock_1 = ConvBlock(filters, filters, **kw)

    def forward(self, x: torch.Tensor, m_pool: Tuple[int, int],
                generator: Optional[torch.Generator] = None):
        skip = self.ConvBlock_1(_dropout(self.ConvBlock_0(x), self.drop,
                                         self.training, generator))
        bad = [f"axis {i} (size {d}, pool {p})"
               for i, (d, p) in enumerate(zip(skip.shape[2:], m_pool))
               if d // int(p) < 1]
        if bad:
            raise ValueError(
                f"DownBlock m_pool={tuple(m_pool)} would pool "
                f"{', '.join(bad)} of shape {tuple(skip.shape)} to zero size. "
                "Reduce DEPTH, enlarge DIM, or use per-level clamped pools "
                "(see effective_pools).")
        return skip, F.max_pool2d(skip, tuple(m_pool), stride=tuple(m_pool))


class UpBlock(nn.Module):
    """upsample + conv, concat [upsampled, skip], conv-drop-conv."""

    def __init__(self, in_ch: int, skip_ch: int, filters: int, drop: float,
                 **kw):
        super().__init__()
        self.act = _ACTIVATIONS[kw["activation"]]
        self.dtype = kw["dtype"]
        self.Conv_0 = nn.Conv2d(in_ch, filters, tuple(kw["f_size"]),
                                padding="same")
        self.ConvBlock_0 = ConvBlock(filters + skip_ch, filters, **kw)
        self.drop = drop
        self.ConvBlock_1 = ConvBlock(filters, filters, **kw)

    def forward(self, lower: torch.Tensor, skip: torch.Tensor,
                up_size: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.act(_conv(self.Conv_0, _upsample_nearest(lower, up_size),
                           self.dtype))
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.ConvBlock_1(_dropout(self.ConvBlock_0(x), self.drop,
                                         self.training, generator))


class UNet(nn.Module):
    """Encoder/decoder 2D U-Net with a sigmoid head (single head)."""

    def __init__(self, in_channels: int = 1, depth: int = 4, filters: int = 32,
                 f_size: Tuple[int, int] = (3, 3),
                 m_pool: Tuple[int, int] = (2, 2), mask_classes: int = 2,
                 dropouts: Tuple[float, ...] = (0.3, 0.4, 0.4, 0.5),
                 drop_bottleneck: float = 0.5, activation: str = "relu",
                 batch_norm: bool = True, bn_first: bool = False,
                 group_norm: int = 0, head_bias_prior=None,
                 logit_softcap=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth = depth
        self.filters = filters
        self.f_size = tuple(f_size)
        self.m_pool = tuple(m_pool)
        self.mask_classes = mask_classes
        self.logit_softcap = logit_softcap
        self.head_bias_prior = head_bias_prior
        self.dtype = dtype
        kw = dict(f_size=tuple(f_size), activation=activation,
                  batch_norm=batch_norm, bn_first=bn_first,
                  group_norm=group_norm, dtype=dtype)
        ch, skips = in_channels, []
        for level in range(depth):
            f = filters * 2 ** level
            self.add_module(f"DownBlock_{level}",
                            DownBlock(ch, f, dropouts[level], **kw))
            skips.append(f)
            ch = f
        bottom = filters * 2 ** depth
        self.ConvBlock_0 = ConvBlock(ch, bottom, **kw)
        self.drop_bottleneck = drop_bottleneck
        self.ConvBlock_1 = ConvBlock(bottom, bottom, **kw)
        ch = bottom
        drops = list(dropouts)
        for i in range(depth):
            f = ch // 2
            # decoder iteration i consumes dropouts from the end, like the
            # reference's dropouts.pop()
            self.add_module(f"UpBlock_{i}",
                            UpBlock(ch, skips[depth - 1 - i], f, drops.pop(),
                                    **kw))
            ch = f
        self.head = nn.Conv2d(ch, mask_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> "UNet":
        """Random init with the reference's initialisers from an explicit
        generator: he_normal conv kernels, zero biases, unit norm scales,
        zero-mean/unit-variance running stats and the head-bias prior."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d):
                    he_normal_(mod.weight, generator)
                    mod.bias.zero_()
                elif isinstance(mod, (nn.GroupNorm, nn.BatchNorm2d)):
                    mod.reset_parameters()
            if self.head_bias_prior is not None:
                p = float(self.head_bias_prior)
                self.head.bias.fill_(float(np.log(p / (1.0 - p))))
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[N, H, W, C] -> [N, H, W, classes] sigmoid probabilities (f32).
        ``generator`` draws the dropout masks in train mode."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        pools, clamped = effective_pools(x.shape[2:], self.m_pool, self.depth)
        if clamped:
            warnings.warn(
                f"UNet: M_POOL={self.m_pool} exhausts an axis before "
                f"DEPTH={self.depth} on input {tuple(x.shape)}; using "
                f"per-level pools {pools}.", stacklevel=2)
        skips = []
        for level in range(self.depth):
            skip, x = getattr(self, f"DownBlock_{level}")(x, pools[level],
                                                          generator)
            skips.append(skip)
        x = self.ConvBlock_1(_dropout(self.ConvBlock_0(x),
                                      self.drop_bottleneck, self.training,
                                      generator))
        for i in range(self.depth):
            x = getattr(self, f"UpBlock_{i}")(x, skips.pop(),
                                              pools[self.depth - 1 - i],
                                              generator)
        logits = F.conv2d(x.to(wide_dtype(self.dtype)), self.head.weight,
                          self.head.bias)
        probs = torch.sigmoid(apply_softcap(logits, self.logit_softcap))
        return probs.permute(0, 2, 3, 1)


def model_summary(model: UNet) -> str:
    """Text summary with the parameter count (counterpart of
    ``cmrtpu.models.unet.model_summary`` -> model_summary.txt): one line per
    parameter under its flax path and shape."""
    from cmrtpu_torch.train.checkpoint import _flatten, state_dict_to_flax

    attrs = " ".join(f"{name}={getattr(model, name)}"
                     for name in ("depth", "filters", "f_size", "m_pool",
                                  "mask_classes", "dtype"))
    lines = [f"{type(model).__name__} {attrs}"]
    params, stats = state_dict_to_flax(model.state_dict())
    total = 0
    for path, leaf in sorted(_flatten(params).items()):
        lines.append(f"  {'/'.join(path):60s} {str(leaf.shape):18s} "
                     f"{leaf.size}")
        total += leaf.size
    lines.append(f"Trainable params: {total}")
    lines.append("BatchNorm statistics: "
                 f"{sum(v.size for v in _flatten(stats).values())}")
    return "\n".join(lines)


def dropout_schedule(config: Dict) -> Tuple[float, ...]:
    """linspace(DROPOUT_MIN, DROPOUT_MAX, DEPTH) rounded to 1 decimal."""
    depth = C.get(config, "DEPTH")
    lin = np.linspace(C.get(config, "DROPOUT_MIN"),
                      C.get(config, "DROPOUT_MAX"), depth)
    return tuple(round(float(v), 1) for v in lin)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to cmrtpu_torch yet (ROADMAP {item}); "
        "serve this config with cmrtpu")


def build_model(config: Dict, supervision: bool = False,
                factorized: bool = False) -> UNet:
    """Model factory from the flat config (counterpart of
    ``cmrtpu.models.unet.build_model``). Parameters are left at torch's
    defaults: load weights, or call ``reset_parameters(generator)``."""
    if C.ndims(config) != 2:
        _not_ported("the 3D U-Net (len(DIM) == 3)", "4.1")
    if factorized or C.get(config, "FACTORIZED_3D", False):
        _not_ported("the (2+1)D factorized U-Net", "4.4")
    if supervision:
        _not_ported("deep supervision", "3.8")
    if C.get(config, "HEADS", ()):
        _not_ported("multi-head HEADS", "3.4")
    if not bool(C.get(config, "USE_UPSAMPLE", True)):
        _not_ported("the transpose-conv decoder (USE_UPSAMPLE: false)", "3.8")
    if C.get(config, "QUANT_INT8", False):
        _not_ported("the int8 twin (QUANT_INT8)", "5.4")
    if C.get(config, "WEIGHT_STANDARDISATION", False):
        _not_ported("WEIGHT_STANDARDISATION (a closed dead-end)", "skip list")
    if C.get(config, "BN_BF16", False) and C.get(config, "MIXED_PRECISION"):
        warnings.warn("BN_BF16 is a TPU memory knob: cmrtpu_torch runs "
                      "BatchNorm in f32 (ROADMAP skip list)", stacklevel=2)
    # REMAT only trades memory for recompute in the backward pass: at
    # inference it changes nothing, so it is accepted and ignored
    act = str(C.get(config, "ACTIVATION")).lower()
    act = act if act in _ACTIVATIONS else "relu"
    dtype = torch.bfloat16 if C.get(config, "MIXED_PRECISION") else torch.float32
    return UNet(
        in_channels=int(C.get(config, "IMG_CHANNELS")),
        depth=C.get(config, "DEPTH"),
        filters=C.get(config, "FILTERS"),
        f_size=tuple(C.get(config, "F_SIZE"))[-2:],
        m_pool=tuple(C.get(config, "M_POOL"))[-2:],
        mask_classes=C.get(config, "MASK_CLASSES"),
        dropouts=dropout_schedule(config),
        drop_bottleneck=float(C.get(config, "DROPOUT_MAX")),
        activation=act,
        batch_norm=bool(C.get(config, "BATCH_NORMALISATION")),
        bn_first=bool(C.get(config, "BN_FIRST")),
        group_norm=int(C.get(config, "GROUP_NORM", 0) or 0),
        head_bias_prior=C.get(config, "HEAD_BIAS_PRIOR", None),
        logit_softcap=C.get(config, "LOGIT_SOFTCAP", None),
        dtype=dtype,
    )
