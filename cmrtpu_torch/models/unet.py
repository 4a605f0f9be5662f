"""2D and 3D U-Net as torch ``nn.Module``s — counterpart of
``cmrtpu/models/unet.py``.

Same blocks, same order, same parameter tree:

  * ConvBlock  = Conv -> norm -> act (BN_FIRST) or Conv+act -> norm
  * DownBlock  = ConvBlock, Dropout, ConvBlock, MaxPool (VALID, window = stride)
  * UpBlock    = nearest Upsample + Conv+act (USE_UPSAMPLE) or transpose
                 Conv+act, Concat([up, skip]), ConvBlock, Dropout, ConvBlock
  * UNet       = depth x DownBlock, bottleneck ConvBlock-Dropout-ConvBlock,
                 depth x UpBlock, 1x1 f32 head + sigmoid, or one 1x1 f32
                 ``head_<name>`` per HEADS entry (sigmoid or softmax)

Submodules carry the flax auto-names (``DownBlock_0/ConvBlock_1/Conv_0`` and
so on), so a ``state_dict`` key is the flax path with ``/`` -> ``.`` and the
weights bridge (``cmrtpu_torch/train/checkpoint.py``) is a rename plus an
HWIO -> OIHW (DHWIO -> OIDHW) transpose, and a spatial flip for the
transpose convolution.

The rank follows the kernel size, as in the reference: ``len(DIM)`` selects
2D (``F_SIZE``/``M_POOL`` right-sliced to 2) or 3D (sliced to 3, a [T, H, W]
cine volume). Public layout follows the JAX package: ``UNet.forward`` takes
``[N, *spatial, C]`` and returns ``[N, *spatial, classes]`` probabilities;
inside, tensors are NCHW or NCDHW. Under ``MIXED_PRECISION`` the convs run
in bf16 on f32 parameters, the norms and the head in f32, as in the
reference.

Ported: the plain 2D and 3D U-Net with GroupNorm, BatchNorm (flax's, train
and eval mode) or no norm, per-level pools clamped where an axis runs out,
the upsample and the transpose-conv decoders, single- or multi-head
outputs, the (2+1)D blocks (``factorized``: FACTORIZED_3D, MODEL_VARIANT
unet_2p1d), deep supervision and the int8 twin of post-training
quantization (``QUANT_INT8``: every ConvBlock's conv is a ``QuantConv``;
``cmrtpu_torch/predict/quantize.py`` writes its weights), the
normalisation-free scaled weight-standardised blocks (``WSConv``,
WEIGHT_STANDARDISATION under WS_I_UNDERSTAND), BatchNorm with its
normalise step in bf16 (``BF16BatchNorm``, BN_BF16 under MIXED_PRECISION)
and per-level rematerialisation (REMAT: ``torch.utils.checkpoint`` around
the Down- and UpBlocks of the shallowest levels). In train mode dropout
draws its masks from an explicit ``torch.Generator`` passed to ``forward``
(flax draws them from the step's dropout key). The hybrids are in
``hybrids.py``.
"""

from __future__ import annotations

import contextlib
import logging
import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cmrtpu_torch import config as C
from cmrtpu_torch.ops.int8_conv import quant_conv
from cmrtpu_torch.parallel.mesh import (all_reduce_sum, batch_stats_mesh,
                                        global_batch_stats)

_ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    # flax's nn.gelu is the tanh approximation by default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
}

# the NF variance-preserving gain of a weight-standardised block's
# activation (Brock et al. 2021, Tab. 5), as cmrtpu's; 1.0 for the others
_WS_GAMMA = {"relu": 1.7139, "gelu": 1.7015, "silu": 1.7881, "elu": 1.2717}


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


def he_normal_(weight: torch.Tensor, generator: torch.Generator,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """flax ``he_normal``: variance_scaling(2.0, 'fan_in', 'truncated_normal'),
    a normal truncated at two standard deviations and rescaled so the
    truncated distribution has variance 2 / fan_in. ``weight`` is OIHW;
    pass ``fan_in`` for other layouts."""
    fan_in = fan_in or weight[0].numel()
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of norms, head and loss: float32 under bf16 or f32
    compute, as in the reference; float64 for a float64 model (a reference
    evaluation of the same math)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# by the number of spatial axes: convolution, transposed convolution and
# max-pool of NCHW (2) and NCDHW (3), and the module classes holding them
_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_CONV_MODULE = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T_MODULE = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector [C] shaped to broadcast over x [N, C, ...]."""
    return v.reshape(-1, *[1] * (x.dim() - 2))


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)`` on f32 params: input, kernel and bias are
    cast to the compute dtype; 'SAME' padding. The bias is added after the
    convolution's output is rounded to ``dtype``, where flax adds it: folding
    it into the bf16 convolution rounds once instead of twice, and the
    difference grows to 0.1 in probability through a depth-3 GroupNorm net."""
    y = _CONV[x.dim() - 2](x.to(dtype), conv.weight.to(dtype),
                           padding="same")
    return y + _channel(conv.bias.to(dtype), y)


def _conv_transpose(conv: nn.Module, x: torch.Tensor,
                    strides: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.ConvTranspose(strides, padding='SAME')`` on f32 params, which
    is ``lax.conv_transpose`` without kernel flip. The bridge stores the
    flax kernel flipped in torch's [in, out, kh, kw], so torch's transposed
    convolution with no padding computes the full output; 'SAME' keeps
    ``n * s`` of it per axis, from ``k - 1 - pad_a`` on, with lax's
    ``pad_a`` (zeros past the full output when s > k). The bias is added
    after rounding to ``dtype``, as in ``_conv``."""
    y = _CONV_T[x.dim() - 2](x.to(dtype), conv.weight.to(dtype),
                             stride=tuple(int(s) for s in strides))
    for axis, (k, s) in enumerate(zip(conv.weight.shape[2:], strides),
                                  start=2):
        k, s = int(k), int(s)
        pad_a = k - 1 if s > k - 1 else int(math.ceil((k + s - 2) / 2))
        start, length = k - 1 - pad_a, x.shape[axis] * s
        short = start + length - y.shape[axis]
        if short > 0:
            pad = [0, 0] * (y.dim() - axis - 1) + [0, short]
            y = F.pad(y, pad)
        y = y.narrow(axis, start, length)
    return y + _channel(conv.bias.to(dtype), y)


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
    keep = _keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _keep_mask(shape, rate: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """Dropout's keep mask: True with probability 1 - rate, drawn from
    ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _upsample_nearest(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour upsampling of NCHW or NCDHW by integer factors per
    spatial axis."""
    for axis, f in enumerate(factors, start=2):
        if f != 1:
            x = x.repeat_interleave(int(f), dim=axis)
    return x


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over the channels
    of NCHW or NCDHW, in the input's (wide) dtype.

    Train mode normalises with the biased batch statistics over N and the
    spatial axes in flax's fast form, var = max(mean(x^2) - mean(x)^2, 0),
    and moves the running averages to ``0.99 * old + 0.01 * batch`` with
    that biased variance (``nn.BatchNorm2d`` would fold in the unbiased
    one). Inside ``mesh.global_batch_stats`` the statistics are the
    global batch's, through one all-reduce of the per-channel sums, so the
    running averages come out the same on every rank. Eval mode reads the
    running averages. Either way y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias, in flax's order. ``weight`` is
    flax's ``scale``. While ``stats_frozen`` is set (a rematerialised
    block's recompute), train mode leaves the running averages alone."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.stats_frozen = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    @staticmethod
    def _global_stats(x: torch.Tensor, dims, mesh):
        """Mean and biased variance over the global batch: one
        differentiable all-reduce of the per-channel sums of x and x^2 and
        of the element count, in flax's mean(x^2) - mean(x)^2 form."""
        c = x.shape[1]
        count = x.new_full((1,), float(x.numel() // c))
        sums = all_reduce_sum(torch.cat([x.sum(dim=dims),
                                         x.square().sum(dim=dims), count]),
                              mesh)
        mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        return mean, torch.clamp(mean_sq - mean.square(), min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0, *range(2, x.dim()))
            mesh = batch_stats_mesh()
            if mesh is None:
                mean = x.mean(dim=dims)
                var = torch.clamp(x.square().mean(dim=dims) - mean.square(),
                                  min=0.0)
            else:
                mean, var = self._global_stats(x, dims, mesh)
            self._move_averages(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - _channel(mean, x)) * _channel(mul, x)
                + _channel(self.bias, x))

    @torch.no_grad()
    def _move_averages(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.stats_frozen:
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


class BF16BatchNorm(BatchNorm):
    """cmrtpu's ``BF16BatchNorm`` (BN_BF16 under MIXED_PRECISION): the
    statistics in float32, the normalise step one per-channel
    multiply-add in the input's dtype (bf16), y = x * inv + (bias - mean *
    inv) with inv = scale * rsqrt(var + eps) rounded to that dtype. Train
    mode takes float32 means of the input and of its square (var =
    max(E[x^2] - E[x]^2, 0)) without a float32 copy of the activation: the
    sums cast as they read, and E[x^2] is the squared float32 2-norm.
    Same parameters and buffers as ``BatchNorm``, so checkpoints
    interchange."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0, *range(2, x.dim()))
            count = float(x.numel() // x.shape[1])
            total = x.sum(dim=dims, dtype=torch.float32)
            square = torch.linalg.vector_norm(
                x, 2, dim=dims, dtype=torch.float32).square()
            mesh = batch_stats_mesh()
            if mesh is not None:
                c = x.shape[1]
                sums = all_reduce_sum(torch.cat([
                    total, square, total.new_full((1,), count)]), mesh)
                total, square, count = sums[:c], sums[c:2 * c], sums[-1]
            mean = total / count
            var = torch.clamp(square / count - mean.square(), min=0.0)
            self._move_averages(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight * torch.rsqrt(var + self.eps)
        return (x * _channel(inv.to(x.dtype), x)
                + _channel((self.bias - mean * inv).to(x.dtype), x))


class WSConv(nn.Module):
    """cmrtpu's scaled weight-standardised conv (``WSConv``; NF-style,
    arXiv:2101.08692): the kernel ``weight`` [O, I, *k] is standardised
    over (in, spatial) per output channel and scaled by ``gain *
    rsqrt(max(var * fan_in, 1e-4))`` (biased variance, fan_in = I *
    prod(k)), then convolves 'same' in the compute dtype, and ``bias`` is
    added after rounding, as in ``_conv``."""

    def __init__(self, in_ch: int, filters: int, f_size: Tuple[int, ...]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(filters, in_ch, *f_size))
        self.bias = nn.Parameter(torch.zeros(filters))
        self.gain = nn.Parameter(torch.ones(filters))

    def kernel(self) -> torch.Tensor:
        """The standardised kernel the conv applies, in float32."""
        w = self.weight
        dims = tuple(range(1, w.dim()))
        mean = w.mean(dim=dims, keepdim=True)
        var = w.var(dim=dims, unbiased=False, keepdim=True)
        scale = self.gain.reshape(-1, *[1] * (w.dim() - 1)) * torch.rsqrt(
            torch.clamp(var * float(w[0].numel()), min=1e-4))
        return (w - mean) * scale

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = _CONV[x.dim() - 2](x.to(dtype), self.kernel().to(dtype),
                               padding="same")
        return y + _channel(self.bias.to(dtype), y)


class QuantConv(nn.Module):
    """cmrtpu's int8 ``QuantConv`` (``cmrtpu/models/unet.py:129``): the
    block input quantized per input channel by ``act_scale``, an int8
    kernel ``kernel_q`` [O, C, *k] with per-output-channel ``w_scale``, an
    int32 'SAME' conv, and ``y * w_scale + bias`` in float32, cast to
    ``dtype`` (``ops/int8_conv.py``). Serving only: every tensor is a
    buffer, nothing trains."""

    def __init__(self, in_ch: int, filters: int, f_size: Tuple[int, ...],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(
            filters, in_ch, *f_size, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(filters))
        self.register_buffer("act_scale", torch.ones(in_ch))
        self.register_buffer("bias", torch.zeros(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_conv(x, self.kernel_q, self.w_scale, self.act_scale,
                          self.bias, self.dtype)


# ConvBlock.quant_mode: the float conv, the float conv recording the
# block input's per-channel max-abs (calibration), or the int8 QuantConv
QUANT_MODES = ("", "calib", "int8")


class ConvBlock(nn.Module):
    """Conv + norm + activation with the reference's ordering switch.

    ``group_norm=N`` uses GroupNorm with min(N, filters) groups, reduced
    until it divides ``filters``; otherwise ``BatchNorm`` when
    ``batch_norm``. Both use epsilon 1e-3 and run in f32; the block output
    is cast to ``dtype``.

    ``factorized`` with a rank-3 ``f_size`` whose t extent exceeds 1 makes
    the conv (2+1)D, as cmrtpu's: ``Conv_0`` is a 2D conv of kernel
    ``f_size[1:]`` over [B * T, C, H, W] (t folded into the batch), then
    the activation, then ``Conv_1``, a (t, 1, 1) conv from ``filters`` to
    ``filters``; the norm and the activation follow as in the plain
    block.

    ``quant_mode`` (cmrtpu's): '' is the float conv; 'int8' replaces it by
    ``QuantConv_0`` (the norm stays float); 'calib' runs the float conv
    and keeps the running per-input-channel max-abs of the block's input
    in ``calib_amax`` (float32 [C], on the input's device), which
    ``predict/quantize.py:calibrate`` reads. Any quant_mode builds the
    unfactorized conv, as in cmrtpu.

    ``ws`` makes the block cmrtpu's normalisation-free one: ``WSConv_0``
    (``QuantConv_0`` in the int8 twin), the activation times its NF gain
    (``_WS_GAMMA``), no norm, no factorisation. ``bn_bf16`` makes the
    BatchNorm a ``BF16BatchNorm`` that takes the conv's output in
    ``dtype``, with no cast to float32."""

    def __init__(self, in_ch: int, filters: int, f_size: Tuple[int, ...],
                 activation: str = "relu", batch_norm: bool = True,
                 bn_first: bool = False, group_norm: int = 0,
                 factorized: bool = False, quant_mode: str = "",
                 ws: bool = False, bn_bf16: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode {quant_mode!r}: expected one of "
                             f"{QUANT_MODES}")
        self.act = _ACTIVATIONS[activation]
        self.bn_first = bn_first
        self.dtype = dtype
        self.quant_mode = quant_mode
        self.calib_amax: Optional[torch.Tensor] = None
        self.ws_gamma = _WS_GAMMA.get(activation, 1.0) if ws else None
        self.factorized = (factorized and len(f_size) == 3 and f_size[0] > 1
                           and not quant_mode and not ws)
        if quant_mode == "int8":
            self.QuantConv_0 = QuantConv(in_ch, filters, tuple(f_size),
                                         dtype)
        elif ws:
            self.WSConv_0 = WSConv(in_ch, filters, tuple(f_size))
        elif self.factorized:
            self.Conv_0 = nn.Conv2d(in_ch, filters, tuple(f_size[1:]),
                                    padding="same")
            self.Conv_1 = nn.Conv3d(filters, filters, (f_size[0], 1, 1),
                                    padding="same")
        else:
            self.Conv_0 = _CONV_MODULE[len(f_size)](in_ch, filters,
                                                    tuple(f_size),
                                                    padding="same")
        self.norm_name: Optional[str] = None
        self.bn_bf16 = False
        if ws:  # normalisation-free
            group_norm, batch_norm = 0, False
        if group_norm:
            groups = min(int(group_norm), filters)
            while filters % groups:  # GroupNorm needs groups | channels
                groups -= 1
            self.norm_name = "GroupNorm_0"
            self.GroupNorm_0 = nn.GroupNorm(groups, filters, eps=1e-3)
        elif batch_norm:
            self.norm_name = "BatchNorm_0"
            self.bn_bf16 = bn_bf16
            self.BatchNorm_0 = BF16BatchNorm(filters) if bn_bf16 \
                else BatchNorm(filters)

    def _norm(self, y: torch.Tensor) -> torch.Tensor:
        if self.norm_name is None:
            return y
        if self.bn_bf16:
            return self.BatchNorm_0(y)
        return getattr(self, self.norm_name)(y.to(wide_dtype(self.dtype)))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant_mode == "int8":
            return self.QuantConv_0(x)
        if self.quant_mode == "calib":
            amax = x.float().abs().amax(dim=(0, *range(2, x.dim())))
            self.calib_amax = amax if self.calib_amax is None \
                else torch.maximum(self.calib_amax, amax)
        if self.ws_gamma is not None:
            return self.WSConv_0(x, self.dtype)
        if not self.factorized:
            return _conv(self.Conv_0, x, self.dtype)
        b, c, t, h, w = x.shape
        y = _conv(self.Conv_0, x.transpose(1, 2).reshape(b * t, c, h, w),
                  self.dtype)
        y = self.act(y).reshape(b, t, -1, h, w).transpose(1, 2)
        return _conv(self.Conv_1, y, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ws_gamma is not None:
            return (self.act(self._conv(x)) * self.ws_gamma).to(self.dtype)
        if self.bn_first:
            x = self.act(self._norm(self._conv(x)))
        else:
            x = self._norm(self.act(self._conv(x)))
        return x.to(self.dtype)


class DownBlock(nn.Module):
    """conv-drop-conv + max-pool; returns (skip, pooled)."""

    def __init__(self, in_ch: int, filters: int, drop: float, **kw):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_ch, filters, **kw)
        self.drop = drop
        self.ConvBlock_1 = ConvBlock(filters, filters, **kw)

    def forward(self, x: torch.Tensor, m_pool: Tuple[int, ...],
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
        return skip, _MAX_POOL[skip.dim() - 2](skip, tuple(m_pool),
                                               stride=tuple(m_pool))


class UpBlock(nn.Module):
    """upsample + conv (or transpose conv), concat [up, skip],
    conv-drop-conv."""

    def __init__(self, in_ch: int, skip_ch: int, filters: int, drop: float,
                 use_upsample: bool = True, **kw):
        super().__init__()
        self.act = _ACTIVATIONS[kw["activation"]]
        self.dtype = kw["dtype"]
        self.use_upsample = use_upsample
        f_size = tuple(kw["f_size"])
        if use_upsample:
            self.Conv_0 = _CONV_MODULE[len(f_size)](in_ch, filters, f_size,
                                                    padding="same")
        else:
            self.ConvTranspose_0 = _CONV_T_MODULE[len(f_size)](
                in_ch, filters, f_size)
        self.ConvBlock_0 = ConvBlock(filters + skip_ch, filters, **kw)
        self.drop = drop
        self.ConvBlock_1 = ConvBlock(filters, filters, **kw)

    def forward(self, lower: torch.Tensor, skip: torch.Tensor,
                up_size: Tuple[int, ...],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.use_upsample:
            x = _conv(self.Conv_0, _upsample_nearest(lower, up_size),
                      self.dtype)
        else:
            x = _conv_transpose(self.ConvTranspose_0, lower, up_size,
                                self.dtype)
        x = self.act(x)
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.ConvBlock_1(_dropout(self.ConvBlock_0(x), self.drop,
                                         self.training, generator))


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisers on every submodule of ``module``, from
    an explicit generator: he_normal conv kernels (the fan-in of a
    transposed kernel [in, out, *k] is in * prod(k), as flax's HWIO /
    DHWIO), zero biases, unit norm scales and WS gains,
    zero-mean/unit-variance running stats."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, tuple(_CONV_MODULE.values())):
                he_normal_(mod.weight, generator)
                mod.bias.zero_()
            elif isinstance(mod, tuple(_CONV_T_MODULE.values())):
                he_normal_(mod.weight, generator,
                           fan_in=mod.weight[:, 0].numel())
                mod.bias.zero_()
            elif isinstance(mod, WSConv):
                he_normal_(mod.weight, generator)
                mod.bias.zero_()
                mod.gain.fill_(1.0)
            elif isinstance(mod, (nn.GroupNorm, BatchNorm)):
                mod.reset_parameters()


def _check_rank(f_size: Sequence[int], m_pool: Sequence[int]) -> None:
    if len(f_size) != len(m_pool) or len(f_size) not in _CONV:
        raise ValueError(f"f_size {tuple(f_size)} and m_pool "
                         f"{tuple(m_pool)} must both have 2 or 3 axes")


def _add_encoder(module: nn.Module, in_ch: int, depth: int, filters: int,
                 dropouts: Sequence[float], drop_bottleneck: float,
                 kw: Dict) -> Tuple[int, ...]:
    """``DownBlock_{level}`` for each level, then the bottleneck's
    ``ConvBlock_0`` and ``ConvBlock_1``, as children of ``module`` under
    flax's auto-names; ``filters`` doubles at every level. Returns the
    skips' channels, shallowest first."""
    skips = []
    ch = in_ch
    for level in range(depth):
        f = filters * 2 ** level
        module.add_module(f"DownBlock_{level}",
                          DownBlock(ch, f, dropouts[level], **kw))
        skips.append(f)
        ch = f
    bottom = filters * 2 ** depth
    module.ConvBlock_0 = ConvBlock(ch, bottom, **kw)
    module.drop_bottleneck = drop_bottleneck
    module.ConvBlock_1 = ConvBlock(bottom, bottom, **kw)
    return tuple(skips)


@contextlib.contextmanager
def _replayed(generator: Optional[torch.Generator], state):
    """Inside the block ``generator`` draws from ``state``, where a
    block's first run started; afterwards it is back where it was."""
    if generator is None:
        yield
        return
    after = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(after)


@contextlib.contextmanager
def _frozen_stats(block: nn.Module):
    """Inside the block the BatchNorms of ``block`` leave their running
    averages alone."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.stats_frozen = False


def _remat(block: nn.Module, generator: Optional[torch.Generator], *args):
    """``block(*args, generator)`` without keeping its activations: the
    backward pass recomputes them (``torch.utils.checkpoint``,
    non-reentrant). The recompute must be the same function as the first
    run, as flax's functional ``nn.remat`` is by construction: it draws
    the same dropout masks (``generator`` replayed from its state at the
    first run; ``checkpoint`` saves only torch's global generators), moves
    no running average a second time and, inside
    ``mesh.global_batch_stats``, reduces BatchNorm's statistics over the
    same mesh (the backward runs outside that block). Every rank
    recomputes, so the all-reduces of the statistics run twice a step."""
    first = {}

    def run(*inputs):
        if not first:
            first["state"] = None if generator is None \
                else generator.get_state()
            first["mesh"] = batch_stats_mesh()
            return block(*inputs, generator=generator)
        with _replayed(generator, first["state"]), _frozen_stats(block), \
                global_batch_stats(first["mesh"]):
            return block(*inputs, generator=generator)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _block(block: nn.Module, remat: bool, generator, *args):
    """``block(*args, generator)``, rematerialised when ``remat`` and
    autograd records (there is nothing to recompute otherwise)."""
    if remat and torch.is_grad_enabled():
        return _remat(block, generator, *args)
    return block(*args, generator=generator)


def _encode(module: nn.Module, x: torch.Tensor, pools, generator,
            n_remat: int = 0):
    """Run ``_add_encoder``'s children on NCHW / NCDHW ``x`` with one pool
    per level, rematerialising the levels below ``n_remat``. Returns
    (encoding, skips shallowest first)."""
    skips = []
    for level, pool in enumerate(pools):
        skip, x = _block(getattr(module, f"DownBlock_{level}"),
                         level < n_remat, generator, x, pool)
        skips.append(skip)
    x = module.ConvBlock_1(_dropout(module.ConvBlock_0(x),
                                    module.drop_bottleneck, module.training,
                                    generator))
    return x, skips


def _add_decoder(module: nn.Module, in_ch: int, skips: Sequence[int],
                 filters: Sequence[int], drops: Sequence[float],
                 use_upsample: bool, kw: Dict) -> int:
    """``UpBlock_{i}`` in forward order (the deepest first) as children of
    ``module``: block i has ``filters[i]`` filters and dropout ``drops[i]``
    and takes the skip of channels ``skips[-1 - i]``. Returns the output
    channels."""
    ch = in_ch
    for i, f in enumerate(filters):
        module.add_module(f"UpBlock_{i}",
                          UpBlock(ch, skips[-1 - i], f, drops[i],
                                  use_upsample=use_upsample, **kw))
        ch = f
    return ch


def _decode(module: nn.Module, x: torch.Tensor, skips, up_sizes, generator,
            n_remat: int = 0):
    """Run ``_add_decoder``'s children, block i upsampling by
    ``up_sizes[i]`` and consuming the deepest skip left; block i builds
    level ``len(up_sizes) - 1 - i`` and is rematerialised when that level
    lies below ``n_remat``. Returns (output, the last block's input)."""
    skips = list(skips)
    lower = x
    for i, up in enumerate(up_sizes):
        lower = x
        x = _block(getattr(module, f"UpBlock_{i}"),
                   len(up_sizes) - 1 - i < n_remat, generator, x,
                   skips.pop(), up)
    return x, lower


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, 1, -1)


class ConvEncoder(nn.Module):
    """The reusable encoder half that cmrtpu exposes for custom models
    (``cmrtpu.models.unet.ConvEncoder``; ref: KerasLayers.py:237-327):
    ``depth`` DownBlocks, ``filters`` doubling at each, then the
    conv-dropout-conv bottleneck. ``forward`` takes [N, *spatial, C] and
    returns ``(encoding, skips)``, channels last, the skips shallowest
    first, in ``dtype``. Pools clamp per level where an axis runs out, with
    cmrtpu's warning; pass the clamped pools reversed as a ``ConvDecoder``'s
    per-level ``up_size`` to mirror them. ``in_channels`` is the input's
    channels (flax infers it); ``out_channels`` and ``skip_channels``
    size the decoder."""

    def __init__(self, in_channels: int = 1, depth: int = 4,
                 filters: int = 32, f_size: Tuple[int, ...] = (3, 3),
                 m_pool: Tuple[int, ...] = (2, 2),
                 dropouts: Tuple[float, ...] = (0.3, 0.4, 0.4, 0.5),
                 drop_bottleneck: float = 0.5, activation: str = "relu",
                 batch_norm: bool = True, bn_first: bool = False,
                 group_norm: int = 0, factorized: bool = False,
                 quant_mode: str = "", ws: bool = False,
                 bn_bf16: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _check_rank(f_size, m_pool)
        self.depth = depth
        self.m_pool = tuple(m_pool)
        self.dtype = dtype
        kw = dict(f_size=tuple(f_size), activation=activation,
                  batch_norm=batch_norm, bn_first=bn_first,
                  group_norm=group_norm, factorized=factorized,
                  quant_mode=quant_mode, ws=ws, bn_bf16=bn_bf16,
                  dtype=dtype)
        self.skip_channels = _add_encoder(self, in_channels, depth, filters,
                                          dropouts, drop_bottleneck, kw)
        self.out_channels = filters * 2 ** depth

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        pools, clamped = effective_pools(x.shape[1:-1], self.m_pool,
                                         self.depth)
        if clamped:
            warnings.warn(
                f"ConvEncoder: m_pool={self.m_pool} exhausts an axis "
                f"before depth={self.depth} on input {tuple(x.shape)}; "
                f"clamped per-level pools to {pools}. Pair with a "
                "ConvDecoder whose up factors mirror these.", stacklevel=2)
        x, skips = _encode(self, torch.movedim(x, -1, 1).to(self.dtype),
                           pools, generator)
        return _channels_last(x), [_channels_last(s) for s in skips]


class ConvDecoder(nn.Module):
    """The reusable decoder half (``cmrtpu.models.unet.ConvDecoder``; ref:
    KerasLayers.py:348-430): ``depth`` UpBlocks over an encoder's
    ``(encoding, skips)``, channels last in and out, no head. As in the
    reference, ``filters`` is the starting (largest) count, halved after
    every block, and ``dropouts[layer]`` applies in forward order:
    ``dropouts[0]`` at the deepest block (``UNet`` consumes its dropouts
    from the end). ``up_size`` is one factor tuple for every block, as in
    cmrtpu, or one tuple per block in forward order, so that the decoder
    can mirror an encoder whose pools were clamped (``effective_pools``
    reversed); cmrtpu takes the single tuple only. ``in_channels`` and
    ``skip_channels`` (shallowest first) are the encoder's
    ``out_channels`` and ``skip_channels``; by default those of the
    symmetric ``ConvEncoder(filters=filters // 2 ** (depth - 1))``."""

    def __init__(self, depth: int = 4, filters: int = 256,
                 f_size: Tuple[int, ...] = (3, 3), up_size=(2, 2),
                 dropouts: Tuple[float, ...] = (0.3, 0.4, 0.4, 0.5),
                 use_upsample: bool = True, activation: str = "relu",
                 batch_norm: bool = True, bn_first: bool = False,
                 group_norm: int = 0, factorized: bool = False,
                 quant_mode: str = "", ws: bool = False,
                 bn_bf16: bool = False,
                 in_channels: Optional[int] = None,
                 skip_channels: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        single = all(isinstance(f, (int, np.integer)) for f in up_size)
        self.up_size = [tuple(int(f) for f in up)
                        for up in ([up_size] * depth if single else up_size)]
        if len(self.up_size) != depth or len(f_size) not in _CONV or any(
                len(up) != len(f_size) for up in self.up_size):
            raise ValueError(
                f"up_size {tuple(up_size)}: one factor tuple of "
                f"len(f_size) = {len(f_size)} axes (2 or 3), or one such "
                f"tuple per block ({depth})")
        per_block = [filters // 2 ** i for i in range(depth)]
        self.dtype = dtype
        kw = dict(f_size=tuple(f_size), activation=activation,
                  batch_norm=batch_norm, bn_first=bn_first,
                  group_norm=group_norm, factorized=factorized,
                  quant_mode=quant_mode, ws=ws, bn_bf16=bn_bf16,
                  dtype=dtype)
        if skip_channels is None:
            skip_channels = per_block[::-1]
        _add_decoder(self, 2 * filters if in_channels is None
                     else in_channels, tuple(skip_channels), per_block,
                     dropouts, use_upsample, kw)

    def forward(self, encoding: torch.Tensor, skips,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, _ = _decode(self, torch.movedim(encoding, -1, 1),
                       [torch.movedim(s, -1, 1) for s in skips],
                       self.up_size, generator)
        return _channels_last(x)


class UNet(nn.Module):
    """Encoder/decoder U-Net with a sigmoid head, or one head per ``heads``
    entry (name, channels, 'sigmoid' | 'softmax'); 2D or 3D by
    ``len(f_size)``.

    ``supervision`` adds cmrtpu's deep-supervision branch: the input of the
    last UpBlock goes through ``Conv_0`` (a 1 x ... x 1 conv to ``filters``
    channels) and the activation, is upsampled nearest by the first level's
    pool and multiplies the decoder's output ahead of the head.

    ``remat`` (cmrtpu's REMAT) recomputes blocks in the backward pass
    instead of keeping their activations: True every DownBlock and
    UpBlock, an int N those of the N shallowest levels (level 0 holds the
    full-resolution activations); the bottleneck never. It changes no
    parameter name and no value, only the memory a train step holds."""

    def __init__(self, in_channels: int = 1, depth: int = 4, filters: int = 32,
                 f_size: Tuple[int, ...] = (3, 3),
                 m_pool: Tuple[int, ...] = (2, 2), mask_classes: int = 2,
                 dropouts: Tuple[float, ...] = (0.3, 0.4, 0.4, 0.5),
                 drop_bottleneck: float = 0.5, activation: str = "relu",
                 batch_norm: bool = True, bn_first: bool = False,
                 group_norm: int = 0, head_bias_prior=None,
                 logit_softcap=None, use_upsample: bool = True,
                 heads: Sequence[Tuple[str, int, str]] = (),
                 factorized: bool = False, supervision: bool = False,
                 quant_mode: str = "", ws: bool = False,
                 bn_bf16: bool = False, remat=False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _check_rank(f_size, m_pool)
        self.depth = depth
        self.n_remat = depth if remat is True else int(remat or 0)
        self.filters = filters
        self.f_size = tuple(f_size)
        self.m_pool = tuple(m_pool)
        self.mask_classes = mask_classes
        self.logit_softcap = logit_softcap
        self.head_bias_prior = head_bias_prior
        self.heads = tuple((str(n), int(c), str(a)) for n, c, a in heads)
        self.supervision = supervision
        self.dtype = dtype
        self.act = _ACTIVATIONS[activation]
        kw = dict(f_size=tuple(f_size), activation=activation,
                  batch_norm=batch_norm, bn_first=bn_first,
                  group_norm=group_norm, factorized=factorized,
                  quant_mode=quant_mode, ws=ws, bn_bf16=bn_bf16,
                  dtype=dtype)
        skips = _add_encoder(self, in_channels, depth, filters, dropouts,
                             drop_bottleneck, kw)
        bottom = filters * 2 ** depth
        # decoder iteration i consumes dropouts from the end, like the
        # reference's dropouts.pop()
        ch = _add_decoder(self, bottom, skips,
                          [bottom // 2 ** (i + 1) for i in range(depth)],
                          list(dropouts)[::-1], use_upsample, kw)
        conv = _CONV_MODULE[len(f_size)]
        if supervision:  # fed the last UpBlock's input, 2 * filters wide
            self.Conv_0 = conv(2 * filters, filters, 1)
        if self.heads:
            for name, channels, _ in self.heads:
                self.add_module(f"head_{name}", conv(ch, channels, 1))
        else:
            self.head = conv(ch, mask_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> "UNet":
        """Random init with the reference's initialisers from an explicit
        generator (``init_weights_``) and the head-bias prior on sigmoid
        heads (a softmax head's common shift is a no-op, so its bias stays
        zero)."""
        init_weights_(self, generator)
        with torch.no_grad():
            if self.head_bias_prior is not None:
                p = float(self.head_bias_prior)
                prior = float(np.log(p / (1.0 - p)))
                if not self.heads:
                    self.head.bias.fill_(prior)
                for name, _, act in self.heads:
                    if act != "softmax":
                        getattr(self, f"head_{name}").bias.fill_(prior)
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """[N, *spatial, C] -> [N, *spatial, classes] sigmoid probabilities
        (f32), or with heads a dict name -> [N, *spatial, channels]
        probabilities. ``generator`` draws the dropout masks in train
        mode."""
        rank = len(self.f_size)
        if x.dim() != rank + 2:
            raise ValueError(f"a {rank}D U-Net takes [N, *spatial, C] of "
                             f"{rank + 2} axes, got {tuple(x.shape)}")
        x = torch.movedim(x, -1, 1).to(self.dtype)
        pools, clamped = effective_pools(x.shape[2:], self.m_pool, self.depth)
        if clamped:
            warnings.warn(
                f"UNet: M_POOL={self.m_pool} exhausts an axis before "
                f"DEPTH={self.depth} on input {tuple(x.shape)}; using "
                f"per-level pools {pools}.", stacklevel=2)
        x, skips = _encode(self, x, pools, generator, self.n_remat)
        x, pre_last = _decode(self, x, skips, pools[::-1], generator,
                              self.n_remat)
        if self.supervision:
            lower = self.act(_conv(self.Conv_0, pre_last, self.dtype))
            x = _upsample_nearest(lower, pools[0]) * x
        x = x.to(wide_dtype(self.dtype))
        if not self.heads:
            return self._head(self.head, x, "sigmoid")
        return {name: self._head(getattr(self, f"head_{name}"), x, act)
                for name, _, act in self.heads}

    def _head(self, conv: nn.Module, x: torch.Tensor,
              act: str) -> torch.Tensor:
        """1x1 conv in the wide dtype, soft cap, then softmax over the
        channels or sigmoid; channels last out."""
        logits = apply_softcap(_CONV[x.dim() - 2](x, conv.weight, conv.bias),
                               self.logit_softcap)
        probs = torch.softmax(logits, dim=1) if act == "softmax" \
            else torch.sigmoid(logits)
        return torch.movedim(probs, 1, -1)


def model_summary(model: nn.Module) -> str:
    """Text summary with the parameter count (counterpart of
    ``cmrtpu.models.unet.model_summary`` -> model_summary.txt): one line per
    parameter under its flax path and shape, for the U-Net and the hybrids
    alike, or under its state_dict name for a model with no flax layout
    (only the attributes a model has are listed)."""
    from cmrtpu_torch.train.checkpoint import (_flatten, has_cmrtpu_layout,
                                               state_dict_to_flax)

    attrs = " ".join(f"{name}={getattr(model, name)}"
                     for name in ("depth", "filters", "f_size", "m_pool",
                                  "mask_classes", "dtype")
                     if hasattr(model, name))
    lines = [f"{type(model).__name__} {attrs}".rstrip()]
    state = model.state_dict()
    if has_cmrtpu_layout(state):
        params, stats = state_dict_to_flax(state)
        leaves = [("/".join(k), v)
                  for k, v in sorted(_flatten(params).items())]
    else:  # its own names (the Swin-Unet)
        leaves = [(k, v.detach().cpu().numpy()) for k, v in state.items()]
        stats = {}
    total = 0
    for path, leaf in leaves:
        lines.append(f"  {path:60s} {str(leaf.shape):18s} {leaf.size}")
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


def build_model(config: Dict, supervision: bool = False,
                factorized: bool = False) -> UNet:
    """Model factory from the flat config (counterpart of
    ``cmrtpu.models.unet.build_model``): ``len(DIM)`` selects 2D or 3D, and
    F_SIZE and M_POOL are right-sliced to that rank. Parameters are left at
    torch's defaults: load weights, or call
    ``reset_parameters(generator)``. WEIGHT_STANDARDISATION raises a
    ValueError without WS_I_UNDERSTAND and logs a warning with it, as
    cmrtpu's factory does."""
    ndims = C.ndims(config)
    if ndims not in _CONV:
        raise ValueError(f"DIM {C.get(config, 'DIM')}: the U-Net is 2D or "
                         "3D")
    quant = bool(C.get(config, "QUANT_INT8", False))
    factorized = bool(factorized or C.get(config, "FACTORIZED_3D", False))
    if quant and factorized:
        # cmrtpu's quantize_model refuses these (cmrtpu/predict/
        # quantize.py:377-390): the twin's blocks are unfactorized
        raise ValueError(
            "int8 PTQ does not support factorized (2+1)D models "
            "(MODEL_VARIANT='unet_2p1d' / FACTORIZED_3D=True); serve the "
            "factorized model in float")
    ws = bool(C.get(config, "WEIGHT_STANDARDISATION", False))
    batch_norm = bool(C.get(config, "BATCH_NORMALISATION"))
    if ws:
        # a closed dead-end in cmrtpu (it collapses to all-zero
        # predictions at flagship scale), so it needs an acknowledgement
        if not C.get(config, "WS_I_UNDERSTAND", False):
            raise ValueError(
                "WEIGHT_STANDARDISATION is a CLOSED experimental dead-end: "
                "it trains at small scale but collapsed to all-zero "
                "predictions on every flagship-scale RVIP config tested "
                "(see IMPLEMENTATION_STATUS.md). Set WS_I_UNDERSTAND=true "
                "to build it anyway (small-scale probes only); use "
                "GROUP_NORM=16 for a stable BatchNorm alternative.")
        logging.warning(
            "WEIGHT_STANDARDISATION (acknowledged via WS_I_UNDERSTAND): "
            "EXPERIMENTAL, collapses at flagship scale%s.",
            "; BATCH_NORMALISATION is ignored for the conv blocks"
            if batch_norm else "")
    act = str(C.get(config, "ACTIVATION")).lower()
    act = act if act in _ACTIVATIONS else "relu"
    dtype = torch.bfloat16 if C.get(config, "MIXED_PRECISION") else torch.float32
    return UNet(
        in_channels=int(C.get(config, "IMG_CHANNELS")),
        depth=C.get(config, "DEPTH"),
        filters=C.get(config, "FILTERS"),
        f_size=tuple(C.get(config, "F_SIZE"))[-ndims:],
        m_pool=tuple(C.get(config, "M_POOL"))[-ndims:],
        mask_classes=C.get(config, "MASK_CLASSES"),
        dropouts=dropout_schedule(config),
        drop_bottleneck=float(C.get(config, "DROPOUT_MAX")),
        activation=act,
        batch_norm=batch_norm,
        bn_first=bool(C.get(config, "BN_FIRST")),
        group_norm=int(C.get(config, "GROUP_NORM", 0) or 0),
        head_bias_prior=C.get(config, "HEAD_BIAS_PRIOR", None),
        logit_softcap=C.get(config, "LOGIT_SOFTCAP", None),
        use_upsample=bool(C.get(config, "USE_UPSAMPLE", True)),
        heads=tuple(tuple(h) for h in C.get(config, "HEADS", ()) or ()),
        factorized=factorized,
        supervision=supervision,
        # the serving-only twin that predict/quantize.py writes
        quant_mode="int8" if quant else "",
        ws=ws,
        bn_bf16=bool(C.get(config, "BN_BF16", False)
                     and C.get(config, "MIXED_PRECISION")),
        remat=C.get(config, "REMAT", False),
        dtype=dtype,
    )
