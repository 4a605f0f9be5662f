"""Plain float32 Swin-Unet (Cao et al., arXiv:2105.05537; the public
code's ``SwinTransformerSys`` at ``swin_tiny_patch4_window7_224``) as a
function of a parameter dict, with its loss and optax's Adam: what the
tests hold ``cmrtpu_torch/models/swin_unet.py`` to. It imports nothing of
``cmrtpu_torch``, ``cmrtpu`` or JAX; ``benchmark/reference/swin_unet.py``
is its copy for the benchmark, with seeded weights, the lower-precision
controls and the first training steps.

Tokens are [N, h, w, C]. Per stage of side (h, w) the window m is
SWIN_WINDOW, or the shorter side where that is at most SWIN_WINDOW (then
unshifted); odd blocks of a stage shift by m // 2 when it is wider than m.

  block    z = x + DP(WMSA_s(LN(x))), x' = z + DP(fc2(GELU(fc1(LN(z)))))
  WMSA_s   the map rolled by (-s, -s) and cut into m x m windows; per
           head softmax(q k^T / sqrt(d) + B + mask) v, then proj, the
           windows put back and the map rolled by (+s, +s). B[h, i, j] =
           T[(r_i - r_j + m - 1)(2m - 1) + c_i - c_j + m - 1, h]; the mask
           is -100 between tokens whose region ids differ, the ids taken
           on the rolled map from the cuts [0, -m), [-m, -s), [-s, end)
  merge    LN(cat[x00, x10, x01, x11]) @ reduction^T (no bias)
  expand   x @ expand^T (no bias), 'b h w (p1 p2 c) -> b (h p1) (w p2) c',
           LN (factor 2 halves the width; the final factor 4 keeps it)
  U        patch conv + LN; encoder stages (input kept as skip), the last
           without merge, LN; expand; per skip from the deepest: concat,
           Linear(2C, C), the mirrored stage's blocks, expand but after
           the shallowest; LN; x4 expand; 1x1 head without bias; sigmoid

Drop path: rates linspace(0, DROP_PATH_RATE, blocks) over the encoder,
each decoder stage reusing its encoder stage's; a branch with a rate above
0 keeps a row where ``torch.rand([N], generator) < 1 - rate``, drawn in
forward order (attention branch, then MLP branch).

``rnd``, a function of a tensor, is applied to the input and the weight
of every linear layer and of the patch convolution, and to q, k and v: a
test rounds them to a lower precision with it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

SETTINGS = {"SWIN_PATCH": 4, "SWIN_EMBED_DIM": 96,
            "SWIN_DEPTHS": [2, 2, 2, 2], "SWIN_HEADS": [3, 6, 12, 24],
            "SWIN_WINDOW": 7, "SWIN_MLP_RATIO": 4, "DROP_PATH_RATE": 0.2}

LN_EPS = 1e-5


def settings(cfg: Dict) -> Dict:
    """The configuration's Swin keys and its stages: [(h, w, m, shift)]
    from the patch grid down."""
    s = {k: cfg.get(k, v) for k, v in SETTINGS.items()}
    patch, window = int(s["SWIN_PATCH"]), int(s["SWIN_WINDOW"])
    stages = []
    for i in range(len(s["SWIN_DEPTHS"])):
        h, w = (int(d) // (patch * 2 ** i) for d in cfg["DIM"])
        m = min(h, w) if min(h, w) <= window else window
        stages.append((h, w, m, m // 2 if min(h, w) > m else 0))
    s["stages"] = stages
    return s


def _region_ids(h: int, w: int, m: int, s: int) -> torch.Tensor:
    """[h, w] region id of each token of the rolled map."""
    r = torch.arange(h)
    c = torch.arange(w)
    rr = (r >= h - m).long() + (r >= h - s).long()
    cc = (c >= w - m).long() + (c >= w - s).long()
    return rr[:, None] * 3 + cc[None, :]


def _windows(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, h, w, C] -> [N, h/m * w/m, m * m, C]."""
    n, h, w, c = x.shape
    return x.reshape(n, h // m, m, w // m, m, c).transpose(2, 3).reshape(
        n, (h // m) * (w // m), m * m, c)


def _unwindows(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n, _, mm, c = x.shape
    m = int(round(mm ** 0.5))
    return x.reshape(n, h // m, w // m, m, m, c).transpose(2, 3).reshape(
        n, h, w, c)


def _bias_index(m: int) -> torch.Tensor:
    r = torch.arange(m).repeat_interleave(m)
    c = torch.arange(m).repeat(m)
    return (r[:, None] - r[None, :] + m - 1) * (2 * m - 1) \
        + (c[:, None] - c[None, :] + m - 1)


class Forward:
    """The reference forward of one configuration; ``train`` with a
    ``generator`` applies drop path."""

    def __init__(self, cfg: Dict, rnd: Optional[Callable] = None):
        self.s = settings(cfg)
        self.rnd = rnd
        self.n = len(self.s["SWIN_DEPTHS"])
        depths = [int(d) for d in self.s["SWIN_DEPTHS"]]
        rates = torch.linspace(0, float(self.s["DROP_PATH_RATE"]),
                               sum(depths), device="cpu").tolist()
        self.rates = [rates[sum(depths[:i]):sum(depths[:i + 1])]
                      for i in range(self.n)]

    def _q(self, t):
        return t if self.rnd is None else self.rnd(t)

    def _lin(self, p, name, x, bias=True):
        y = self._q(x) @ self._q(p[f"{name}.weight"]).t()
        return y + p[f"{name}.bias"] if bias else y

    @staticmethod
    def _ln(p, name, x):
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                            p[f"{name}.bias"], LN_EPS)

    def _dp(self, x, rate, generator):
        if generator is None or rate == 0.0:
            return x
        keep = torch.rand((x.shape[0],), generator=generator,
                          device=x.device) < 1.0 - rate
        return x * (keep.float() / (1.0 - rate)).reshape(-1, 1, 1, 1)

    def _attention(self, p, b, x, i, shift):
        h, w, m, _ = self.s["stages"][i]
        heads = int(self.s["SWIN_HEADS"][i])
        n, _, _, c = x.shape
        d = c // heads
        if shift:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        win = _windows(x, m)  # [N, nW, T, C]
        nw, t = win.shape[1], win.shape[2]
        qkv = self._lin(p, f"{b}.attn.qkv", win).reshape(
            n, nw, t, 3, heads, d)
        q, k, v = (self._q(qkv[..., j, :, :].transpose(2, 3))
                   for j in range(3))  # [N, nW, heads, T, d]
        scores = (q * d ** -0.5) @ k.transpose(-2, -1)
        table = p[f"{b}.attn.relative_position_bias_table"]
        bias = table[_bias_index(m).to(table.device)].permute(2, 0, 1)
        scores = scores + bias
        if shift:
            ids = _windows(_region_ids(h, w, m, shift)[None, :, :, None]
                           .to(x.device), m)[0, :, :, 0]  # [nW, T]
            differ = ids[:, :, None] != ids[:, None, :]
            scores = scores + torch.where(differ, -100.0, 0.0)[None, :,
                                                                None]
        out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(2, 3).reshape(n, nw, t, c)
        out = _unwindows(self._lin(p, f"{b}.attn.proj", out), h, w)
        if shift:
            out = torch.roll(out, (shift, shift), (1, 2))
        return out

    def _stage(self, p, pre, x, i, generator):
        shift = self.s["stages"][i][3]
        for j, rate in enumerate(self.rates[i]):
            b = f"{pre}.blocks.{j}"
            a = self._attention(p, b, self._ln(p, f"{b}.norm1", x), i,
                                shift if j % 2 else 0)
            x = x + self._dp(a, rate, generator)
            z = self._lin(p, f"{b}.mlp.fc1", self._ln(p, f"{b}.norm2", x))
            z = self._lin(p, f"{b}.mlp.fc2", F.gelu(z))
            x = x + self._dp(z, rate, generator)
        return x

    def _expand(self, p, name, x, factor):
        n, h, w, _ = x.shape
        y = self._lin(p, f"{name}.expand", x, bias=False)
        c = y.shape[-1] // factor ** 2
        y = y.reshape(n, h, w, factor, factor, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h * factor, w * factor, c)
        return self._ln(p, f"{name}.norm", y)

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 train: bool = True,
                 generator: Optional[torch.Generator] = None,
                 logits: bool = False) -> torch.Tensor:
        """x [N, H, W, C] -> probabilities [N, H, W, classes] (or the
        head's logits). Drop path only in ``train`` with a
        ``generator``."""
        gen = generator if train else None
        patch = int(self.s["SWIN_PATCH"])
        h = F.conv2d(self._q(x.permute(0, 3, 1, 2).float()),
                     self._q(p["patch_embed.proj.weight"]),
                     p["patch_embed.proj.bias"], stride=patch)
        h = self._ln(p, "patch_embed.norm", h.permute(0, 2, 3, 1))
        skips = []
        for i in range(self.n):
            skips.append(h)
            h = self._stage(p, f"layers.{i}", h, i, gen)
            if i < self.n - 1:
                pre = f"layers.{i}.downsample"
                h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                               h[:, 0::2, 1::2], h[:, 1::2, 1::2]], dim=-1)
                h = self._lin(p, f"{pre}.reduction",
                              self._ln(p, f"{pre}.norm", h), bias=False)
        h = self._expand(p, "layers_up.0", self._ln(p, "norm", h), 2)
        for k in range(1, self.n):
            i = self.n - 1 - k
            h = self._lin(p, f"concat_back_dim.{k}",
                          torch.cat([h, skips[i]], dim=-1))
            h = self._stage(p, f"layers_up.{k}", h, i, gen)
            if i > 0:
                h = self._expand(p, f"layers_up.{k}.upsample", h, 2)
        h = self._expand(p, "up", self._ln(p, "norm_up", h), patch)
        out = h @ p["output.weight"][:, :, 0, 0].t()
        return out if logits else torch.sigmoid(out)


KERAS_EPS = 1e-7


def bce_dice_loss(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """mean keras binary cross-entropy minus the smoothed soft Dice."""
    q = torch.clamp(p, KERAS_EPS, 1.0 - KERAS_EPS)
    bce = -(y * torch.log(q + KERAS_EPS)
            + (1.0 - y) * torch.log(1.0 - q + KERAS_EPS))
    yt, yp = y.reshape(-1), p.reshape(-1)
    dice = (2.0 * torch.sum(yt * yp) + 1.0) / (torch.sum(yt) + torch.sum(yp)
                                                + 1.0)
    return bce.mean() - dice


class Adam:
    """optax.adam(lr, b1=0.9, b2=0.999, eps) on a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 eps: float = 1e-8):
        self.lr, self.eps, self.t = float(lr), float(eps), 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - float(np.float32(0.9)) ** self.t
        bc2 = 1.0 - float(np.float32(0.999)) ** self.t
        for k, g in grads.items():
            self.mu[k].mul_(0.9).add_(g, alpha=0.1)
            self.nu[k].mul_(0.999).addcmul_(g, g, value=0.001)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps)
            params[k].sub_(self.lr * upd)
