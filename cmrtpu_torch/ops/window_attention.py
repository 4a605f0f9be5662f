"""The Swin-Unet's shifted-window attention between a block's qkv and proj
linears, on tokens in their natural order: K3 (``csrc/window_attention.cu``)
on a CUDA device, through ``window_attention``, and its plain twin
``window_attention_plain`` everywhere else.

qkv [N, h, w, 3C] (last axis (3, heads, d)) -> out [N, h, w, C]. The map
rolled by (-s, -s) is cut into m x m windows; ``window_token_index`` names
each window's tokens by their pixels in the map as it is, so the roll and
the partition are addressing, and each output row goes back to the pixel
its token came from. Per window and head, in the compute dtype of qkv
(``lo``) and float32 or wider (``acc``):

  S = scale * q k^T + B + mask_s   q k^T from lo values into an acc sum
  P = softmax(S)                   acc
  O = lo(P) v                      an acc sum, rounded to lo once

B is the bias [heads, T, T] (T = m * m) and mask_s the block's shift mask
[windows of an image, T, T], or None. The backward
(``window_attention_backward_plain``, K3's formulas), with dO = d(out):

  dV = lo(P)^T dO,  dP = dO v^T,  dS = P (dP - rowsum(P dP)),
  dQ = scale lo(dS) k,  dK = scale lo(dS)^T q,  dB = the sum of dS over
  windows and images,

each product an acc sum rounded to lo once; rowsum(P dP) is rowsum(dO O)
of flash attention's backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cmrtpu_torch.ops.cuda_kernels import (window_attention_backward_cuda,
                                           window_attention_forward_cuda)


def window_token_index(h: int, w: int, m: int, s: int,
                       device=None) -> torch.Tensor:
    """[windows of an image, m * m] int64: the pixel y * w + x of each
    token of each m x m window of the map rolled by (-s, -s), windows and
    their tokens in row order: token t of window (wr, wc) is pixel
    ((wr * m + t // m + s) mod h, (wc * m + t % m + s) mod w)."""
    rows = (torch.arange(h, device=device) + s) % h
    cols = (torch.arange(w, device=device) + s) % w
    pix = rows[:, None] * w + cols[None, :]
    return pix.view(h // m, m, w // m, m).transpose(1, 2).reshape(-1, m * m)


def _windows(x: torch.Tensor, idx: torch.Tensor, parts: int,
             heads: int) -> torch.Tensor:
    """[N, h, w, K * C] -> [K, N, windows, heads, T, C / heads]: each
    window's tokens gathered by ``idx``, split into K ``parts`` and
    heads."""
    n, h, w, kc = x.shape
    nw, t = idx.shape
    x = x.reshape(n, h * w, kc)[:, idx].view(n, nw, t, parts, heads,
                                             kc // (parts * heads))
    return x.permute(3, 0, 1, 4, 2, 5)


def _unwindow(x: torch.Tensor, idx: torch.Tensor, h: int,
              w: int) -> torch.Tensor:
    """[N, windows, T, K * C] -> [N, h, w, K * C]: each row back at the
    pixel ``idx`` took it from."""
    n, nw, t, c = x.shape
    inverse = torch.argsort(idx.flatten())
    return x.reshape(n, nw * t, c)[:, inverse].view(n, h, w, c)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[N, windows, heads, T, d] -> [N, windows, T, heads * d]."""
    n, nw, heads, t, d = x.shape
    return x.transpose(2, 3).reshape(n, nw, t, heads * d)


def _scores(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
            mask: Optional[torch.Tensor], scale: float,
            acc: torch.dtype) -> torch.Tensor:
    """S [N, windows, heads, T, T] in ``acc``."""
    s = (q.to(acc) @ k.to(acc).transpose(-2, -1)) * scale + bias.to(acc)
    if mask is not None:
        s = s + mask.to(acc)[None, :, None]
    return s


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           heads: int, window: int, shift: int, scale: float,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K3's forward as plain tensor code, on any device and dtype, with
    autograd: qkv [N, h, w, 3C], bias [heads, T, T], ``mask`` the shift
    mask [windows of an image, T, T] or None -> [N, h, w, C] in qkv's
    dtype."""
    lo, acc = qkv.dtype, _acc(qkv.dtype)
    _, h, w, _ = qkv.shape
    idx = window_token_index(h, w, window, shift, qkv.device)
    q, k, v = _windows(qkv, idx, 3, heads)
    attn = torch.softmax(_scores(q, k, bias, mask, scale, acc), dim=-1)
    out = (attn.to(lo).to(acc) @ v.to(acc)).to(lo)
    return _unwindow(_merge_heads(out), idx, h, w)


def window_attention_backward_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                    dout: torch.Tensor, heads: int,
                                    window: int, shift: int, scale: float,
                                    mask: Optional[torch.Tensor] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's backward as plain tensor code: (d(qkv) [N, h, w, 3C] in qkv's
    dtype, d(bias) [heads, T, T] in the wider of its dtype and float32)
    from the output's gradient ``dout`` [N, h, w, C], by the formulas of
    the module's docstring, P recomputed from the row's log-sum-exp."""
    lo, acc = qkv.dtype, _acc(qkv.dtype)
    _, h, w, _ = qkv.shape
    idx = window_token_index(h, w, window, shift, qkv.device)
    q, k, v = (t.to(acc) for t in _windows(qkv, idx, 3, heads))
    do = _windows(dout, idx, 1, heads)[0].to(acc)
    s = _scores(q, k, bias, mask, scale, acc)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dv = p.to(lo).to(acc).transpose(-2, -1) @ do
    dp = do @ v.transpose(-2, -1)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds_lo = ds.to(lo).to(acc)
    dq = (ds_lo @ k) * scale
    dk = (ds_lo.transpose(-2, -1) @ q) * scale
    dqkv = torch.cat([_merge_heads(g.to(lo)) for g in (dq, dk, dv)], dim=-1)
    return _unwindow(dqkv, idx, h, w), ds.sum(dim=(0, 1))


class _WindowAttentionK3(torch.autograd.Function):
    """K3's forward and backward under autograd; d(bias) flows on to the
    bias table's gather."""

    @staticmethod
    def forward(ctx, qkv, bias, heads, window, shift, scale):
        out, lse = window_attention_forward_cuda(qkv, bias, heads, window,
                                                 shift, scale)
        ctx.save_for_backward(qkv, bias, lse)
        ctx.args = (heads, window, shift, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, lse = ctx.saved_tensors
        dqkv, dbias = window_attention_backward_cuda(
            qkv, bias, lse, dout.contiguous(), *ctx.args)
        return dqkv, dbias, None, None, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                     window: int, shift: int, scale: float) -> torch.Tensor:
    """K3 with autograd: qkv bf16 [N, h, w, 3 * heads * 32] and bias
    float32 [heads, T, T], contiguous on a CUDA device, the shift mask
    derived from the map's regions -> bf16 [N, h, w, C]. Launches or
    raises (``cuda_kernels.window_attention_forward_cuda``)."""
    return _WindowAttentionK3.apply(qkv, bias, heads, window, shift, scale)
