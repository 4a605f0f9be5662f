"""Plain float32 Swin-Unet (Cao et al., arXiv:2105.05537; the public
code's ``SwinTransformerSys`` at ``swin_tiny_patch4_window7_224``) as a
function of a parameter dict, with its first training steps. It imports
nothing of the program under test.

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

Parameter names are the program's ``named_parameters()``. ``make_weights``
seeds them as the public code initialises: linear weights and the bias
tables a normal of sd 0.02 (timm's truncation at +-2 cuts nothing at that
sd), biases 0, LayerNorm 1 and 0, the two convs torch's default (uniform
in +-1 / sqrt(fan_in), weight and bias).

``quant`` (``QUANTS`` of ``reference/unet.py``: float8 e4m3 or int8, each
with its rounding of the gradient) rounds the input and the weight of
every linear layer and of the patch convolution, and q, k and v; the head
stays float32. These are the controls the correctness check rejects.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import augment as A
from benchmark.reference import train as R
from benchmark.reference.unet import QUANTS, _round  # noqa: F401

WEIGHT_STREAM = 2  # weights from SEED + 2, as benchmark/weights.py
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


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind is 'normal' (sd 0.02),
    'zero', 'one' or 'conv' (torch's default uniform, bound
    1 / sqrt(fan_in) of the conv it belongs to)."""
    s = settings(cfg)
    embed, depths = int(s["SWIN_EMBED_DIM"]), s["SWIN_DEPTHS"]
    heads, ratio = s["SWIN_HEADS"], float(s["SWIN_MLP_RATIO"])
    patch, n = int(s["SWIN_PATCH"]), len(depths)
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, cin, cout, bias=True):
        spec.append((f"{name}.weight", (cout, cin), "normal"))
        if bias:
            spec.append((f"{name}.bias", (cout,), "zero"))

    def ln(name, c):
        spec.append((f"{name}.weight", (c,), "one"))
        spec.append((f"{name}.bias", (c,), "zero"))

    def blocks(pre, i):
        c, m = embed * 2 ** i, s["stages"][i][2]
        for j in range(int(depths[i])):
            b = f"{pre}.blocks.{j}"
            ln(f"{b}.norm1", c)
            spec.append((f"{b}.attn.relative_position_bias_table",
                         ((2 * m - 1) ** 2, int(heads[i])), "normal"))
            lin(f"{b}.attn.qkv", c, 3 * c)
            lin(f"{b}.attn.proj", c, c)
            ln(f"{b}.norm2", c)
            lin(f"{b}.mlp.fc1", c, int(c * ratio))
            lin(f"{b}.mlp.fc2", int(c * ratio), c)

    cin = int(cfg["IMG_CHANNELS"])
    spec.append(("patch_embed.proj.weight", (embed, cin, patch, patch),
                 "conv"))
    spec.append(("patch_embed.proj.bias", (embed,), "conv"))
    ln("patch_embed.norm", embed)
    for i in range(n):
        blocks(f"layers.{i}", i)
        if i < n - 1:
            c = embed * 2 ** i
            ln(f"layers.{i}.downsample.norm", 4 * c)
            lin(f"layers.{i}.downsample.reduction", 4 * c, 2 * c, False)
    top = embed * 2 ** (n - 1)
    ln("norm", top)
    lin("layers_up.0.expand", top, 2 * top, False)
    ln("layers_up.0.norm", top // 2)
    for k in range(1, n):
        i = n - 1 - k
        c = embed * 2 ** i
        lin(f"concat_back_dim.{k}", 2 * c, c)
        blocks(f"layers_up.{k}", i)
        if i > 0:
            lin(f"layers_up.{k}.upsample.expand", c, 2 * c, False)
            ln(f"layers_up.{k}.upsample.norm", c // 2)
    ln("norm_up", embed)
    lin("up.expand", embed, patch * patch * embed, False)
    ln("up.norm", embed)
    spec.append(("output.weight", (int(cfg["MASK_CLASSES"]), embed, 1, 1),
                 "conv"))
    return spec


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from SEED + 2: one normal
    draw for every 'normal' leaf, one uniform draw for the convs'."""
    spec = param_spec(cfg)
    g = torch.Generator(device).manual_seed(seed + WEIGHT_STREAM)
    normal = [(n, s) for n, s, k in spec if k == "normal"]
    sizes = [math.prod(s) for _, s in normal]
    flat = torch.randn(sum(sizes), generator=g, device=device) * 0.02
    out = {n: t.reshape(s) for (n, s), t in zip(normal, flat.split(sizes))}
    fan_in = {n.rsplit(".", 1)[0]: math.prod(s[1:]) for n, s, k in spec
              if k == "conv" and n.endswith(".weight")}
    for name, shape, kind in spec:
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "conv":
            bound = 1.0 / math.sqrt(fan_in[name.rsplit(".", 1)[0]])
            u = torch.rand(shape, generator=g, device=device)
            out[name] = (2.0 * u - 1.0) * bound
    return out


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

    def __init__(self, cfg: Dict, quant=None):
        self.s = settings(cfg)
        self.quant = quant
        self.n = len(self.s["SWIN_DEPTHS"])
        depths = [int(d) for d in self.s["SWIN_DEPTHS"]]
        rates = torch.linspace(0, float(self.s["DROP_PATH_RATE"]),
                               sum(depths), device="cpu").tolist()
        self.rates = [rates[sum(depths[:i]):sum(depths[:i + 1])]
                      for i in range(self.n)]

    def _q(self, t):
        return _round(t, self.quant)

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


def run_steps(cfg: Dict, seed: int, weights: Dict[str, torch.Tensor],
              data_x: torch.Tensor, data_y: torch.Tensor, rows: np.ndarray,
              quant=None) -> Dict:
    """``len(rows)`` training steps from ``weights`` over the cache on its
    device, as ``reference/train.py:run_steps`` runs them (augmentation
    from SEED + 1, drop path from SEED, BCE + Dice, optax's Adam). Returns
    each step's loss, the first step's gradient, the first step's
    gradient with the loss over the first half of the rows only
    (``grad_half``), the first step's logits and their gradient
    (``logits``, ``logit_grad``, [N, H, W, classes]) and the parameters'
    change after the last step."""
    dev = data_x.device
    fwd = Forward(cfg, quant=quant)
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = R.Adam(params, cfg["LEARNING_RATE"], cfg.get("EPSILON", 1e-8))
    aug_g = torch.Generator(dev).manual_seed(seed + 1)
    drop_g = torch.Generator(dev).manual_seed(seed)
    batch = int(cfg["BATCHSIZE"])
    out: Dict = {"loss": []}
    for step, ids in enumerate(rows):
        idx = torch.as_tensor(np.asarray(ids), device=dev)
        imgs = data_x.index_select(0, idx).float()
        msks = data_y.index_select(0, idx).float()
        if cfg.get("AUGMENT"):
            imgs, msks = A.apply_params(A.draw_params(aug_g, cfg, batch),
                                        imgs, msks)
        x, y = A.targets(imgs, msks, cfg)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        logits = fwd(leaves, x, train=True, generator=drop_g, logits=True)
        prob = torch.sigmoid(logits)
        loss = R.bce_dice_loss(y, prob)
        names = list(leaves)
        if step == 0:
            *grads, lgrad = torch.autograd.grad(
                loss, [*leaves.values(), logits], retain_graph=True)
            half = max(1, batch // 2)
            ghalf = torch.autograd.grad(
                R.bce_dice_loss(y[:half], prob[:half]),
                list(leaves.values()))
            out["grad"] = {k: g.detach().clone() for k, g in
                           zip(names, grads)}
            out["grad_half"] = dict(zip(names, ghalf))
            out["logits"] = logits.detach()
            out["logit_grad"] = lgrad.detach()
        else:
            grads = torch.autograd.grad(loss, list(leaves.values()))
        for v in params.values():
            v.requires_grad_(False)
        opt.step(params, dict(zip(names, grads)))
        out["loss"].append(float(loss.detach()))
    out["change"] = {k: params[k] - weights[k].float() for k in params}
    return out
