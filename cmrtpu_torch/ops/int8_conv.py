"""The int8 convolution of the post-training-quantized twin — counterpart of
the conv that ``cmrtpu/models/unet.py:129`` ``QuantConv`` computes.

cmrtpu quantizes a block's input per input channel (``x / act_scale``,
rounded half to even, clipped to +-127, int8), convolves it with the int8
kernel under 'SAME' padding with int32 accumulation
(``lax.conv_general_dilated(preferred_element_type=int32)``) and rescales
``y * w_scale + bias`` in float32. That conv is an XLA op in cmrtpu, not a
Pallas kernel, so the port computes it on a library GEMM: an im2col of the
int8 input, zero-padded for 'SAME', into ``torch._int_mm``. The same route
runs on the CPU and the card, so the CPU tests exercise its padding.

``torch._int_mm`` on CUDA refuses an A of 16 rows or fewer and a K or N
that is not a multiple of 8 (its errors on the H100 with torch 2.11:
"self.size(0) needs to be greater than 16", "self.size(1) needs to be
greater than 0 and a multiple of 8", "mat2.size(1) needs to be greater
than 0 and a multiple of 8"), and cuBLASLt itself returned
CUBLAS_STATUS_NOT_SUPPORTED for 17 rows, K 8-24 and N 32 with a row-major
B, where a column-major B and a row count that is a multiple of 8 passed
every case tried. So the rows are padded to a multiple of 8 (at least
24), K and N to multiples of 8, all with zeros, and B goes in column-major
(the kernel's [O, K] rows, transposed as a view). A zero column of A
against a zero row of B adds 0 to every int32 sum, so the sums stay exact.
The first block has K = 9 (3 x 3 taps, one channel), padded to 16.

Bound on the H100: an int8 GEMM of M x K x N runs at up to 1,979 TOP/s,
and the im2col writes M x K bytes the GEMM reads again, so at the
flagship's widths (K = 288-576, N = 32) the conv is bound by bytes, not by
the tensor cores. FP8 would be faster on the card but computes another
function than cmrtpu's twin (e4m3 rounds the activations to 3 mantissa
bits): int8 is kept, so the twin is the same function in both packages.

``int8_conv_plain`` is the plain version: a float64 convolution of the
int8 values, exact because every product is below 127**2 and every sum of
27 * C_in of them below 2**53. Tests and chip_smoke hold the GEMM route to
it bit for bit; the main path does not call it.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# torch._int_mm's shape rules on CUDA (see the module docstring)
_MIN_ROWS = 24
_MULTIPLE = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def same_padding(k: int) -> Tuple[int, int]:
    """lax's 'SAME' padding of a stride-1 window of ``k`` taps: (low,
    high) with the odd one on the high side."""
    total = k - 1
    return total // 2, total - total // 2


def quantize_activations(x: torch.Tensor,
                         act_scale: torch.Tensor) -> torch.Tensor:
    """[N, C, *spatial] -> int8: ``x / act_scale`` per channel in float32,
    rounded half to even (``torch.round`` rounds as ``jnp.round``), clipped
    to +-127."""
    scale = act_scale.reshape(-1, *[1] * (x.dim() - 2))
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def im2col(q: torch.Tensor, f_size: Sequence[int]) -> torch.Tensor:
    """int8 [N, C, *spatial] -> [N * prod(spatial), C * taps]: channels
    last, each channel's taps in row-major window order (the order of an
    OIHW / OIDHW kernel reshaped to [O, C * taps]), zero-padded for
    'SAME'."""
    pad = []
    for k in reversed(list(f_size)):  # F.pad takes the last axis first
        pad.extend(same_padding(int(k)))
    padded = F.pad(q, pad).movedim(1, -1)          # [N, *spatial_p, C]
    spatial = q.shape[2:]
    taps = []
    for offset in itertools.product(*(range(int(k)) for k in f_size)):
        index = (slice(None),) + tuple(
            slice(o, o + n) for o, n in zip(offset, spatial))
        taps.append(padded[index])
    cols = torch.stack(taps, dim=-1)               # [N, *spatial, C, taps]
    return cols.reshape(-1, q.shape[1] * len(taps))


def int8_conv(q: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """The 'SAME' stride-1 convolution of int8 [N, C, *spatial] with an int8
    kernel [O, C, *k] (OIHW / OIDHW), summed in int32 -> int32 [N, O,
    *spatial]: im2col into ``torch._int_mm`` with rows, K and N padded with
    zeros to what ``_int_mm`` takes on CUDA."""
    if q.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {q.dtype} and "
                        f"{kernel_q.dtype}")
    if q.dim() != kernel_q.dim() or q.shape[1] != kernel_q.shape[1]:
        raise ValueError(f"int8_conv: input {tuple(q.shape)} and kernel "
                         f"{tuple(kernel_q.shape)} do not match")
    cols = im2col(q, kernel_q.shape[2:])
    m, k = cols.shape
    n = kernel_q.shape[0]
    rows = max(_round_up(m, _MULTIPLE), _MIN_ROWS)
    k_pad, n_pad = _round_up(k, _MULTIPLE), _round_up(n, _MULTIPLE)
    if (rows, k_pad) != (m, k):
        cols = F.pad(cols, (0, k_pad - k, 0, rows - m))
    # [O, K] rows padded, then viewed as the column-major [K, O]
    weights = F.pad(kernel_q.reshape(n, k), (0, k_pad - k, 0, n_pad - n))
    y = torch._int_mm(cols.contiguous(), weights.t())[:m, :n]
    return y.reshape(q.shape[0], *q.shape[2:], n).movedim(-1, 1)


def int8_conv_plain(q: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """The plain version of ``int8_conv``: a float64 'SAME' convolution of
    the int8 values, exact (every partial sum is an integer below 2**53),
    cast to int32."""
    rank = q.dim() - 2
    pad = []
    for k in reversed(list(kernel_q.shape[2:])):
        pad.extend(same_padding(int(k)))
    conv = F.conv2d if rank == 2 else F.conv3d
    y = conv(F.pad(q.double(), pad), kernel_q.double())
    return y.to(torch.int32)


def quant_conv(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
               act_scale: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """cmrtpu's ``QuantConv`` on [N, C, *spatial]: quantize, the int8 conv,
    then ``y.float() * w_scale + bias`` per output channel, cast to
    ``dtype``."""
    y = int8_conv(quantize_activations(x, act_scale), kernel_q)
    shape = (-1, *[1] * (y.dim() - 2))
    return (y.float() * w_scale.reshape(shape)
            + bias.reshape(shape)).to(dtype)
