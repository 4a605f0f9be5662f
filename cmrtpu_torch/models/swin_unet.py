"""Swin-Unet (Cao et al., "Swin-Unet: Unet-like Pure Transformer for
Medical Image Segmentation", arXiv:2105.05537; the public code's
``SwinTransformerSys``, config ``swin_tiny_patch4_window7_224``) as the
port's MODEL_VARIANT 'swin_unet'.

Same interface as the U-Net: ``forward`` takes [N, H, W, C] and returns
[N, H, W, MASK_CLASSES] sigmoid probabilities; dropout's place is taken by
drop path, whose per-sample masks come from the ``generator`` passed to
``forward`` in train mode. Tokens stay [N, h, w, C] from the patch grid
down, so the cyclic shift and the window partition are a roll and a
reshape.

  patch embed  4x4 conv at stride 4 from IMG_CHANNELS to SWIN_EMBED_DIM,
               then LayerNorm
  Swin block   z = x + DP(WMSA_s(LN(x))), x' = z + DP(MLP(LN(z))),
               MLP = Linear(C, rC) -> GELU (erf) -> Linear(rC, C); s
               alternates 0 and floor(M / 2); a stage whose side is at
               most M attends over its whole side, unshifted
  WMSA_s       roll by (-s, -s), M x M windows, qkv = Linear(C, 3C), per
               head softmax(q k^T / sqrt(d) + B + mask_s) v, Linear(C, C),
               windows reversed, roll by (+s, +s); B[h, i, j] is the
               learned table T[(dr + M - 1)(2M - 1) + dc + M - 1, h];
               mask_s is -100 between tokens of different regions of the
               shifted map ([0, -M), [-M, -s), [-s, end) on each axis)
  encoder      stage i keeps its input as skip i, runs its blocks and,
               but the last, merges 2x2 neighbours: LN(4C) then
               Linear(4C, 2C) without bias; LayerNorm after the last
  decoder      patch expand (Linear(C, 2C) without bias, rearranged to
               twice the side at C / 2, LN), then for the skips from the
               deepest up: concat [x, skip], Linear(2C, C), the mirrored
               stage's blocks, patch expand but after the first stage; LN;
               the x4 expand (Linear(C, 16C) without bias, rearranged to
               four times the side at C, LN); a 1x1 conv to MASK_CLASSES
               without bias, soft cap (LOGIT_SOFTCAP) and sigmoid

Drop path rises linearly from 0 to DROP_PATH_RATE over the encoder's
blocks, and each decoder stage takes its mirrored encoder stage's rates,
as the public code does; a [N] keep mask is drawn for each branch whose
rate is above 0, attention branch first, in forward order, all of them
before the forward runs.

The forward from the patch embedding to the x4 expand's LN runs as a plan
of pieces (``SwinUnet.plan``): each block's attention branch is a piece,
and so is each stretch between two of them. A train step with gradients
on a CUDA device runs each piece as a CUDA graph (one for its forward, one
for its backward; ``make_graphed_callables``), captured at the first step
of each input shape, so the host launches 58 graphs a step where it
launched each of their kernels; the head runs eagerly after them. A
piece's graph reads the parameters' storage, so the optimizer's in-place
updates reach it, and a replaced parameter makes it capture again.
Forward hooks inside the pieces do not fire in a graphed step (the head's
do); ``cuda_graphs = False`` runs the pieces eagerly everywhere.

Precision: under MIXED_PRECISION the patch embedding's convolution, every
linear layer and the attention's two matrix products run in bfloat16 on
float32 parameters; LayerNorm, the softmax with the bias table and the
mask added to the scores, the residual stream and its sums, drop path and
the 1x1 head stay in float32. Without it everything is float32.

Parameter names are the public code's (``layers.0.blocks.1.attn.qkv.weight``,
``layers_up.1.upsample.expand.weight``, ``concat_back_dim.2.weight``), and
the module has no cmrtpu layout: ``train/checkpoint.py`` saves its
``state_dict`` under those names. The relative-position index and the
shift masks are non-persistent buffers. Each block's attention branch
(LN1, WMSA_s, drop path and the sum) is the span ``swin.attention`` (arg
``stage``), graphed or not, and the counter ``swin.windows`` adds the
windows it attends.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cmrtpu_torch import config as C
from cmrtpu_torch.models.unet import apply_softcap
from cmrtpu_torch.utils.profiling import GLOBAL_TIMER, span

# the value mask_s takes between tokens of different regions (the public
# code's)
MASK_VALUE = -100.0


def window_partition(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, H, W, C] -> [N * (H / m) * (W / m), m * m, C], windows in row
    order."""
    n, h, w, c = x.shape
    x = x.view(n, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, m * m, c)


def window_reverse(x: torch.Tensor, m: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``: [N * nW, m * m, C] ->
    [N, h, w, C]."""
    c = x.shape[-1]
    x = x.view(-1, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def relative_position_index(m: int) -> torch.Tensor:
    """[m * m, m * m] index into the bias table: (dr + m - 1)(2m - 1) +
    dc + m - 1 for tokens i, j of a window, dr and dc their row and column
    differences."""
    r, c = torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij")
    r, c = r.flatten(), c.flatten()
    dr = r[:, None] - r[None, :] + m - 1
    dc = c[:, None] - c[None, :] + m - 1
    return dr * (2 * m - 1) + dc


def shift_mask(h: int, w: int, m: int, s: int) -> torch.Tensor:
    """[nW, m * m, m * m] additive mask of the map rolled by (-s, -s):
    ``MASK_VALUE`` between tokens of different regions, 0 within one."""
    ids = torch.zeros(1, h, w, 1)
    cuts = (slice(0, -m), slice(-m, -s), slice(-s, None))
    region = 0
    for rows in cuts:
        for cols in cuts:
            ids[:, rows, cols, :] = region
            region += 1
    win = window_partition(ids, m).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _linear(layer: nn.Linear, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """A linear layer in the compute dtype on float32 parameters."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _residual(x: torch.Tensor, branch: torch.Tensor,
              keep: Optional[torch.Tensor]) -> torch.Tensor:
    """x + the branch in float32, scaled by its drop-path ``keep`` [N, 1, 1,
    1] where there is one."""
    branch = branch.float()
    return x + (branch if keep is None else branch * keep)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside M x M windows with the learned
    relative-position bias."""

    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)

    def bias(self) -> torch.Tensor:
        """B [heads, M * M, M * M], float32."""
        n = self.window ** 2
        return self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].view(
                n, n, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        """x [N * nW, M * M, C] windows -> the same shape in ``dtype``;
        ``mask`` [nW, M * M, M * M] or None."""
        bw, n, c = x.shape
        qkv = _linear(self.qkv, x, dtype).reshape(
            bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        scores = (q @ k.transpose(-2, -1)).float() + self.bias().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.view(bw // nw, nw, self.heads, n, n)
                      + mask[None, :, None]).view(bw, self.heads, n, n)
        attn = torch.softmax(scores, dim=-1).to(dtype)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return _linear(self.proj, out, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, dtype)), dtype)


class SwinBlock(nn.Module):
    """One Swin block at a stage of side (h, w), window ``window`` and
    shift ``shift`` (0 for W-MSA): two residual branches,
    ``attention_branch`` and ``mlp_branch``."""

    def __init__(self, dim: int, resolution: Tuple[int, int], heads: int,
                 window: int, shift: int, mlp_ratio: float,
                 drop_path: float, stage: str, dtype: torch.dtype):
        super().__init__()
        self.resolution, self.window, self.shift = resolution, window, shift
        self.drop_path, self.stage, self.dtype = float(drop_path), stage, dtype
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = shift_mask(*resolution, window, shift) if shift else None
        self.register_buffer("attn_mask", mask, persistent=False)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """WMSA_s of LN(x) [N, h, w, C] -> [N, h, w, C] in the compute
        dtype."""
        n, h, w, _ = x.shape
        m, s = self.window, self.shift
        x = x.to(self.dtype)
        if s:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        out = window_reverse(self.attn(window_partition(x, m),
                                       self.attn_mask, self.dtype), m, h, w)
        if s:
            out = torch.roll(out, shifts=(s, s), dims=(1, 2))
        return out

    def attention_branch(self, x: torch.Tensor,
                         keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x + DP(WMSA_s(LN1(x)))."""
        return _residual(x, self.attend(self.norm1(x)), keep)

    def mlp_branch(self, x: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x + DP(MLP(LN2(x)))."""
        return _residual(x, self.mlp(self.norm2(x), self.dtype), keep)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (x[0::2, 0::2], x[1::2, 0::2],
    x[0::2, 1::2], x[1::2, 1::2]), LN(4C), Linear(4C, 2C) without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return _linear(self.reduction, self.norm(x), dtype).float()


class PatchExpand(nn.Module):
    """A linear expand without bias, rearranged 'b h w (p1 p2 c) -> b (h p1)
    (w p2) c' at p = ``scale``, then LN: ``scale`` 2 doubles the side and
    halves the width (``expand`` C -> 2C), ``scale`` 4 quadruples the side
    and keeps the width (C -> 16C)."""

    def __init__(self, dim: int, scale: int):
        super().__init__()
        self.scale = scale
        out = dim // 2 if scale == 2 else dim
        self.expand = nn.Linear(dim, scale * scale * out, bias=False)
        self.norm = nn.LayerNorm(out)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, h, w, _ = x.shape
        p = self.scale
        x = _linear(self.expand, x, dtype)
        c = x.shape[-1] // (p * p)
        x = x.view(n, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(
            n, h * p, w * p, c)
        return self.norm(x.float())


class SwinStage(nn.Module):
    """A stage's blocks, then its merge (encoder) or expand (decoder)."""

    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int,
                 heads: int, window: int, mlp_ratio: float,
                 rates: List[float], stage: str, dtype: torch.dtype,
                 downsample: bool = False, upsample: bool = False):
        super().__init__()
        shift = window // 2 if min(resolution) > window else 0
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, heads, window,
                      0 if j % 2 == 0 else shift, mlp_ratio, rates[j],
                      stage, dtype) for j in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim)
        if upsample:
            self.upsample = PatchExpand(dim, 2)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[N, C, H, W] -> tokens [N, H / p, W / p, dim], float32."""
        y = F.conv2d(x.to(dtype), self.proj.weight.to(dtype),
                     self.proj.bias.to(dtype), stride=self.proj.stride)
        return self.norm(y.permute(0, 2, 3, 1).float())


def _keep(u: torch.Tensor, rate: float) -> torch.Tensor:
    """Drop path's per-sample scale [N, 1, 1, 1] from uniforms ``u`` [N]:
    each row kept where u < 1 - rate and scaled by 1 / (1 - rate)."""
    kept = 1.0 - rate
    return ((u < kept).to(torch.float32) / kept).view(-1, 1, 1, 1)


class _Piece(nn.Module):
    """Steps of the forward that run one after the other: a block's
    attention branch alone (``attention``: the block's stage and window),
    or the steps between two attention branches. It is the unit of a CUDA
    graph, so its parameters are its steps' own. A step is
    ``(fn(x, skip, keep), modules, rate)``; ``forward(x, [skip],
    *uniforms)`` takes the stage's skip where a step concatenates it, and
    in train mode a [N] uniform for each step with drop path."""

    def __init__(self, steps: List[Tuple],
                 attention: Optional[Tuple[str, int]] = None,
                 takes_skip: bool = False, saves_skip: bool = False):
        super().__init__()
        self.steps, self.attention = steps, attention
        self.takes_skip, self.saves_skip = takes_skip, saves_skip
        self.rates = [rate for _, _, rate in steps if rate > 0]
        self.parts = nn.ModuleList(
            {id(m): m for _, ms, _ in steps for m in ms}.values())

    def forward(self, x: torch.Tensor, *extra: torch.Tensor) -> torch.Tensor:
        skip = extra[0] if self.takes_skip else None
        uniforms = iter(extra[1:] if self.takes_skip else extra)
        for fn, _, rate in self.steps:
            u = next(uniforms, None) if rate > 0 else None
            x = fn(x, skip, None if u is None else _keep(u, rate))
        return x


class SwinUnet(nn.Module):
    """The Swin-Unet of one configuration (``config.swin_settings``)."""

    def __init__(self, in_channels: int = 1, mask_classes: int = 2,
                 patch: int = 4, embed_dim: int = 96,
                 depths=(2, 2, 2, 2), heads=(3, 6, 12, 24),
                 stages=((56, 56, 7), (28, 28, 7), (14, 14, 7), (7, 7, 7)),
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 logit_softcap=None, dtype: torch.dtype = torch.bfloat16,
                 cuda_graphs: bool = True):
        super().__init__()
        self.dtype, self.logit_softcap = dtype, logit_softcap
        self.cuda_graphs = cuda_graphs
        self._runtime: Dict = {}  # the plan's pieces and their graphs
        self.mask_classes = mask_classes
        n = len(depths)
        total = sum(depths)
        dpr = torch.linspace(0, drop_path_rate, total, device="cpu").tolist()
        starts = [sum(depths[:i]) for i in range(n)]
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch)
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, stages[i][:2], depths[i], heads[i],
                      stages[i][2], mlp_ratio,
                      dpr[starts[i]:starts[i] + depths[i]], f"enc{i}",
                      dtype, downsample=i < n - 1) for i in range(n))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (n - 1))
        up: List[nn.Module] = [PatchExpand(embed_dim * 2 ** (n - 1), 2)]
        back: List[nn.Module] = [nn.Identity()]
        for k in range(1, n):
            i = n - 1 - k  # the mirrored encoder stage
            dim = embed_dim * 2 ** i
            back.append(nn.Linear(2 * dim, dim))
            up.append(SwinStage(dim, stages[i][:2], depths[i], heads[i],
                                stages[i][2], mlp_ratio,
                                dpr[starts[i]:starts[i] + depths[i]],
                                f"dec{i}", dtype, upsample=i > 0))
        self.layers_up = nn.ModuleList(up)
        self.concat_back_dim = nn.ModuleList(back)
        self.norm_up = nn.LayerNorm(embed_dim)
        self.up = PatchExpand(embed_dim, patch)
        self.output = nn.Conv2d(embed_dim, mask_classes, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> "SwinUnet":
        """The public code's initialisation from ``generator``: linear
        weights and the bias tables a normal of sd 0.02 (timm's
        ``trunc_normal_``, truncated at +-2, which at that sd cuts
        nothing), linear biases 0, LayerNorm 1 and 0, the two convs torch's
        default (kaiming-uniform weights, bias uniform in
        +-1 / sqrt(fan_in))."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, nn.Linear):
                    nn.init.trunc_normal_(module.weight, std=0.02,
                                          generator=generator)
                    if module.bias is not None:
                        module.bias.zero_()
                elif isinstance(module, nn.LayerNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                elif isinstance(module, WindowAttention):
                    nn.init.trunc_normal_(module.relative_position_bias_table,
                                          std=0.02, generator=generator)
                elif isinstance(module, nn.Conv2d):
                    nn.init.kaiming_uniform_(module.weight, a=math.sqrt(5),
                                             generator=generator)
                    if module.bias is not None:
                        bound = 1.0 / math.sqrt(module.weight[0].numel())
                        nn.init.uniform_(module.bias, -bound, bound,
                                         generator=generator)
        return self

    def __getstate__(self) -> Dict:
        # the plan's steps and the graphs are rebuilt for a copy
        return dict(self.__dict__, _runtime={})

    def plan(self) -> List[_Piece]:
        """The forward from the patch embedding to the x4 expand's LN as
        pieces (``_Piece``), in order: each block's attention branch is a
        piece of its own, the steps between two of them another. New
        pieces at each call, over this model's modules."""
        dt = self.dtype
        pieces: List[_Piece] = []
        steps: List[Tuple] = []
        takes_skip = False

        def cut() -> None:
            nonlocal takes_skip
            if steps:
                pieces.append(_Piece(list(steps), takes_skip=takes_skip))
                steps.clear()
                takes_skip = False

        def blocks(stage: nn.Module, saves_skip: bool) -> None:
            for j, b in enumerate(stage.blocks):
                cut()
                pieces.append(_Piece(
                    [(lambda x, s, k, b=b: b.attention_branch(x, k),
                      (b.norm1, b.attn), b.drop_path)],
                    attention=(b.stage, b.window),
                    saves_skip=saves_skip and j == 0))
                steps.append((lambda x, s, k, b=b: b.mlp_branch(x, k),
                              (b.norm2, b.mlp), b.drop_path))

        def module(m: nn.Module, *args) -> None:
            steps.append((lambda x, s, k, m=m: m(x, *args), (m,), 0.0))

        module(self.patch_embed, dt)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            blocks(layer, i < n - 1)
            if hasattr(layer, "downsample"):
                module(layer.downsample, dt)
        module(self.norm)
        for k, layer in enumerate(self.layers_up):
            if k == 0:
                module(layer, dt)
                continue
            lin = self.concat_back_dim[k]
            steps.append((lambda x, s, _, lin=lin: _linear(
                lin, torch.cat([x, s], dim=-1), dt).float(), (lin,), 0.0))
            takes_skip = True
            blocks(layer, False)
            if hasattr(layer, "upsample"):
                module(layer.upsample, dt)
        steps.append((lambda x, s, k: self.up(self.norm_up(x), dt),
                      (self.norm_up, self.up), 0.0))
        cut()
        return pieces

    def _pieces(self) -> List[_Piece]:
        if "pieces" not in self._runtime:
            self._runtime["pieces"] = self.plan()
        return self._runtime["pieces"]

    def _uniforms(self, n: int, generator: Optional[torch.Generator],
                  device) -> List[torch.Tensor]:
        """Train mode: a [N] uniform from ``generator`` for each branch
        with drop path, in forward order (a block's attention branch
        before its MLP's); none in eval mode."""
        rates = [r for piece in self._pieces() for r in piece.rates]
        if not self.training or not rates:
            return []
        if generator is None:
            raise ValueError("train-mode drop path needs an explicit "
                             "torch.Generator (forward(x, generator=...))")
        return [torch.rand((n,), generator=generator, device=device)
                for _ in rates]

    def _run(self, plan: List[_Piece], calls, x: torch.Tensor,
             uniforms: List[torch.Tensor], spans: bool = True
             ) -> torch.Tensor:
        """The plan's pieces, each through its call (the piece itself, or
        its graph), from the image [N, C, H, W] to the last LN's tokens,
        each given its skip and its uniforms; with ``spans`` an attention
        piece is the span ``swin.attention`` and adds its windows to
        ``swin.windows``."""
        skips: List[torch.Tensor] = []
        draws = iter(uniforms)
        for piece, call in zip(plan, calls):
            if piece.saves_skip:
                skips.append(x)
            extra = [skips.pop()] if piece.takes_skip else []
            if uniforms:
                extra += [next(draws) for _ in piece.rates]
            if piece.attention is None or not spans:
                x = call(x, *extra)
                continue
            stage, m = piece.attention
            n, h, w, _ = x.shape
            GLOBAL_TIMER.count("swin.windows", n * (h // m) * (w // m))
            with span("swin.attention", stage=stage):
                x = call(x, *extra)
        return x

    def _graphs(self, x: torch.Tensor, uniforms: List[torch.Tensor]
                ) -> Optional[List[nn.Module]]:
        """The pieces as CUDA graphs for inputs of ``x``'s shape, captured
        at the first train step of that shape (``make_graphed_callables``:
        one forward and one backward graph a piece) and again where a
        parameter was replaced: a graph reads the parameters' storage, so
        in-place updates reach it. None while a parameter is frozen."""
        graphs = self._runtime.setdefault("graphs", {})
        key = (tuple(x.shape), x.dtype, x.device, len(uniforms))
        got = graphs.get(key)
        if got is not None and all(
                d[name] is p and p.data_ptr() == ptr and p.requires_grad
                for d, name, p, ptr in got[1]):
            return got[0]
        graphs.pop(key, None)
        slots = [(m._parameters, name, p, p.data_ptr())
                 for m in self.modules()
                 for name, p in m._parameters.items() if p is not None]
        if not all(p.requires_grad for _, _, p, _ in slots):
            return None
        plan = self.plan()
        samples: List[Tuple[torch.Tensor, ...]] = []

        def sample(i: int, piece: _Piece):
            def call(*args):
                # the activation and the skip carry gradients, the
                # uniforms and the image do not
                args = tuple(a.detach().clone() for a in args)
                for a in args[:1 + piece.takes_skip]:
                    a.requires_grad_(i > 0)
                samples.append(args)
                return piece(*args)
            return call

        with torch.no_grad():
            self._run(plan, [sample(i, piece) for i, piece
                             in enumerate(plan)], x, uniforms, spans=False)
        calls = list(torch.cuda.make_graphed_callables(tuple(plan),
                                                       tuple(samples)))
        graphs[key] = (calls, slots)
        return calls

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[N, H, W, C] -> [N, H, W, classes] sigmoid probabilities (f32);
        ``generator`` draws the drop-path masks in train mode. A train
        step with gradients on a CUDA device runs the pieces as CUDA
        graphs (``cuda_graphs``); the head runs eagerly after them."""
        if x.dim() != 4:
            raise ValueError("the Swin-Unet takes [N, H, W, C], got "
                             f"{tuple(x.shape)}")
        x = torch.movedim(x, -1, 1)
        uniforms = self._uniforms(x.shape[0], generator, x.device)
        calls = None
        if (self.cuda_graphs and self.training and x.is_cuda
                and torch.is_grad_enabled()):
            calls = self._graphs(x, uniforms)
        x = self._run(self._pieces(), calls or self._pieces(), x, uniforms)
        logits = self.output(x.permute(0, 3, 1, 2))
        probs = torch.sigmoid(apply_softcap(logits, self.logit_softcap))
        return torch.movedim(probs, 1, -1)


def build_swin_unet(config: Dict) -> SwinUnet:
    """The Swin-Unet of a flat config (MODEL_VARIANT 'swin_unet'): the
    SWIN_* keys and DROP_PATH_RATE (``config.SWIN_DEFAULTS`` where unset),
    IMG_CHANNELS, MASK_CLASSES, LOGIT_SOFTCAP and MIXED_PRECISION. HEADS
    raises: the model has one output."""
    if C.get(config, "HEADS", ()):
        raise ValueError("MODEL_VARIANT='swin_unet' with HEADS: the "
                         "Swin-Unet has one output, not a dict of heads")
    s = C.swin_settings(config)
    return SwinUnet(
        in_channels=int(C.get(config, "IMG_CHANNELS")),
        mask_classes=int(C.get(config, "MASK_CLASSES")),
        patch=int(s["SWIN_PATCH"]), embed_dim=int(s["SWIN_EMBED_DIM"]),
        depths=tuple(int(d) for d in s["SWIN_DEPTHS"]),
        heads=tuple(int(h) for h in s["SWIN_HEADS"]),
        stages=tuple(s["stages"]),
        mlp_ratio=float(s["SWIN_MLP_RATIO"]),
        drop_path_rate=float(s["DROP_PATH_RATE"]),
        logit_softcap=C.get(config, "LOGIT_SOFTCAP", None),
        dtype=torch.bfloat16 if C.get(config, "MIXED_PRECISION")
        else torch.float32)
