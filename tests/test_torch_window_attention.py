"""K3, the Swin-Unet's shifted-window attention (``csrc/window_attention.cu``
through ``cmrtpu_torch/ops/window_attention.py``), and its plain twin.

On the CPU: the twin in natural token order, with the shift in its
addressing, against the roll / partition / reverse path the model ran
before it, at the four stage shapes of Swin-T at 224² (56², 28², 14², 7²;
window 7), shifted and not; its explicit backward against autograd in
float64; the token index; the wrappers' refusals; the launch geometry.

Tests marked ``card`` need a CUDA card (an H100: the kernel is built for
sm_90a) and skip without one. They hold K3 against the twin at the same
shapes at batch 24, bit for bit against itself, with its launches counted,
and the whole Swin-Unet's K3 route against its twin route. Run them on a
card from the root of a checkout with

    python -m pytest -q -o addopts="" --noconftest -p no:cacheprovider \\
        -m card tests/test_torch_window_attention.py
"""

import pytest
import torch
import torch.nn.functional as F

from cmrtpu_torch.models import swin_unet as S
from cmrtpu_torch.ops import cuda_kernels as K
from cmrtpu_torch.ops.window_attention import (
    window_attention, window_attention_backward_plain,
    window_attention_plain, window_token_index)
from cmrtpu_torch.utils.profiling import GLOBAL_TIMER

WINDOW = 7
# (side, width, heads) of Swin-T's four stages at 224²: head dim 32
STAGES = [(56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24)]
CASES = [(side, dim, heads, shift) for side, dim, heads in STAGES
         for shift in (0, WINDOW // 2)]
IDS = [f"{side}-s{shift}" for side, _, _, shift in CASES]
# float32 twin against the float32 roll path: the scale applied to the sum
# q k^T rather than to q, and sums in another order; rounding only
F32_TOL = 2e-5
# the cell's batch
BATCH = 24


def _mask(side, shift):
    return S.shift_mask(side, side, WINDOW, shift) if shift else None


def _attention(dim, heads, seed):
    """A WindowAttention with weights of sd 0.1 and a bias table of sd 0.5:
    scores of sd about 1, so each row's softmax is far from uniform and far
    from one-hot."""
    attn = S.WindowAttention(dim, WINDOW, heads)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        attn.relative_position_bias_table.mul_(5.0)
    return attn


def _roll_partition_reverse(attn, x, shift, mask):
    """The block's attention as the model ran it before K3: roll by
    (-s, -s), window partition, qkv, q scaled, q k^T + B + mask, softmax,
    A v, proj, window reverse, roll back; float32."""
    n, h, w, c = x.shape
    m, heads = attn.window, attn.heads
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    win = S.window_partition(x, m)
    bw, t, _ = win.shape
    qkv = F.linear(win, attn.qkv.weight, attn.qkv.bias).reshape(
        bw, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * attn.scale, qkv[1], qkv[2]
    scores = q @ k.transpose(-2, -1) + attn.bias().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.view(bw // nw, nw, heads, t, t)
                  + mask[None, :, None]).view(bw, heads, t, t)
    out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(
        bw, t, c)
    out = S.window_reverse(F.linear(out, attn.proj.weight, attn.proj.bias),
                           m, h, w)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out


@pytest.mark.parametrize("side,dim,heads,shift", CASES, ids=IDS)
def test_twin_in_token_order_equals_the_roll_partition_reverse_path(
        side, dim, heads, shift):
    attn = _attention(dim, heads, seed=side + shift)
    x = torch.randn(2, side, side, dim,
                    generator=torch.Generator().manual_seed(side))
    mask = _mask(side, shift)
    with torch.no_grad():
        got = attn(x, shift, mask, torch.float32)
        want = _roll_partition_reverse(attn, x, shift, mask)
    assert got.shape == want.shape == (2, side, side, dim)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("side,dim,heads,shift", CASES, ids=IDS)
def test_explicit_backward_equals_autograd_in_float64(side, dim, heads,
                                                      shift):
    """K3's backward formulas (P from the log-sum-exp, D = rowsum(P dP),
    dB summed over windows and images) against autograd of the twin."""
    g = torch.Generator().manual_seed(100 + side + shift)
    c = dim
    qkv = torch.randn(2, side, side, 3 * c, generator=g,
                      dtype=torch.float64)
    bias = 2.0 * torch.randn(heads, WINDOW ** 2, WINDOW ** 2, generator=g,
                             dtype=torch.float64)
    dout = torch.randn(2, side, side, c, generator=g, dtype=torch.float64)
    mask = _mask(side, shift)
    mask = None if mask is None else mask.double()
    scale = (c // heads) ** -0.5
    leaves = [qkv.clone().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    out = window_attention_plain(*leaves, heads, WINDOW, shift, scale,
                                 mask=mask)
    want = torch.autograd.grad(out, leaves, dout)
    got = window_attention_backward_plain(qkv, bias, dout, heads, WINDOW,
                                          shift, scale, mask=mask)
    assert got[0].dtype == got[1].dtype == torch.float64
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("h,w,m,s", [(56, 56, 7, 3), (14, 14, 7, 0),
                                     (12, 8, 4, 1), (7, 7, 7, 0)])
def test_token_index_is_the_rolled_map_partitioned(h, w, m, s):
    pix = torch.arange(h * w).view(1, h, w, 1)
    rolled = torch.roll(pix, shifts=(-s, -s), dims=(1, 2))
    want = S.window_partition(rolled, m)[..., 0]
    torch.testing.assert_close(window_token_index(h, w, m, s), want,
                               rtol=0, atol=0)


def _valid():
    qkv = torch.zeros(2, 14, 14, 3 * 64, dtype=torch.bfloat16)
    return qkv, torch.zeros(2, 49, 49)


@pytest.mark.parametrize("case,error,match", [
    ("float32 qkv", TypeError, "bfloat16"),
    ("float64 bias", TypeError, "float32"),
    ("head dim 16", ValueError, "head dim"),
    ("window 9", ValueError, "m \\* m <= 64"),
    ("shift = window", ValueError, "shift < m"),
    ("side 15", ValueError, "multiples of m"),
    ("bias heads", ValueError, "bias must be"),
    ("strided qkv", ValueError, "contiguous"),
    ("cpu", ValueError, "CUDA tensors"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, error, match):
    qkv, bias = _valid()
    heads, window, shift = 2, 7, 3
    if case == "float32 qkv":
        qkv = qkv.float()
    elif case == "float64 bias":
        bias = bias.double()
    elif case == "head dim 16":
        heads = 4
    elif case == "window 9":
        window, shift = 9, 4
        qkv = torch.zeros(2, 18, 18, 3 * 64, dtype=torch.bfloat16)
        bias = torch.zeros(2, 81, 81)
    elif case == "shift = window":
        shift = 7
    elif case == "side 15":
        qkv = torch.zeros(2, 15, 14, 3 * 64, dtype=torch.bfloat16)
    elif case == "bias heads":
        bias = torch.zeros(3, 49, 49)
    elif case == "strided qkv":
        qkv = torch.zeros(2, 14, 28, 3 * 64, dtype=torch.bfloat16)[:, :, ::2]
    with pytest.raises(error, match=match):
        K.window_attention_forward_cuda(qkv, bias, heads, window, shift, 0.2)


def test_backward_wrapper_and_autograd_entry_raise_off_the_card():
    qkv, bias = _valid()
    lse = torch.zeros(2, 8, 49)
    dout = torch.zeros(2, 14, 14, 64, dtype=torch.bfloat16)
    launches = (K.window_attention_forward_cuda.launches,
                K.window_attention_backward_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.window_attention_backward_cuda(qkv, bias, lse, dout, 2, 7, 3, 0.2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        window_attention(qkv, bias, 2, 7, 3, 0.2)
    assert launches == (K.window_attention_forward_cuda.launches,
                        K.window_attention_backward_cuda.launches)


@pytest.mark.parametrize("side,heads,group,blocks", [
    (56, 3, 9, 171), (28, 6, 5, 77), (14, 12, 3, 32), (7, 24, 2, 12)])
def test_geometry_at_the_cells_stages(side, heads, group, blocks):
    """About four blocks a SM at batch 24, every window in one block."""
    windows, got_group, got_blocks = K.window_attention_geometry(
        BATCH, side, side, WINDOW, heads)
    assert windows == BATCH * (side // WINDOW) ** 2
    assert (got_group, got_blocks) == (group, blocks)
    assert (blocks - 1) * group < windows <= blocks * group


# --------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode (its plain twin "
                    "is tested above)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin in float32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _gap(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# K3 against its twin in bf16: the same operations, so they differ only
# where a float32 sum taken in another order rounds a probability, dS or
# an output to the other neighbouring bf16 value (about 2**-9 of it): the
# norm of the difference read 2.3e-5 to 6.4e-5 of the twin's on an H100
# (PERF.md); a wrong window, shift, mask or head reads 0.1 or more
BF16_GAP = 1e-3
# d(bias) stays float32: sums of dS in another order (read at most 3.3e-7)
DBIAS_GAP = 1e-5


def _inputs(side, dim, heads, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(BATCH, side, side, 3 * dim, generator=g)
    bias = torch.randn(heads, WINDOW ** 2, WINDOW ** 2, generator=g)
    dout = torch.randn(BATCH, side, side, dim, generator=g)
    return (qkv.to(device, torch.bfloat16), bias.to(device),
            dout.to(device, torch.bfloat16))


@pytest.mark.card
@pytest.mark.parametrize("side,dim,heads,shift", CASES, ids=IDS)
def test_k3_forward_and_backward_against_the_twin(card, side, dim, heads,
                                                  shift):
    qkv, bias, dout = _inputs(side, dim, heads, card, seed=side + shift)
    scale = (dim // heads) ** -0.5
    mask = _mask(side, shift)
    mask = None if mask is None else mask.to(card)
    f0 = K.window_attention_forward_cuda.launches
    b0 = K.window_attention_backward_cuda.launches
    out, lse = K.window_attention_forward_cuda(qkv, bias, heads, WINDOW,
                                               shift, scale)
    out2, lse2 = K.window_attention_forward_cuda(qkv, bias, heads, WINDOW,
                                                 shift, scale)
    grads = K.window_attention_backward_cuda(qkv, bias, lse, dout, heads,
                                             WINDOW, shift, scale)
    grads2 = K.window_attention_backward_cuda(qkv, bias, lse, dout, heads,
                                              WINDOW, shift, scale)
    torch.cuda.synchronize()
    assert K.window_attention_forward_cuda.launches - f0 == 2
    assert K.window_attention_backward_cuda.launches - b0 == 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))

    want = window_attention_plain(qkv, bias, heads, WINDOW, shift, scale,
                                  mask=mask)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert _gap(out, want) < BF16_GAP
    dqkv, dbias = grads
    want_dqkv, want_dbias = window_attention_backward_plain(
        qkv, bias, dout, heads, WINDOW, shift, scale, mask=mask)
    assert dqkv.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    for part in range(3):  # q, k, v
        sl = slice(part * dim, (part + 1) * dim)
        assert _gap(dqkv[..., sl], want_dqkv[..., sl]) < BF16_GAP, part
    assert _gap(dbias, want_dbias) < DBIAS_GAP


def _swin(cuda_graphs):
    model = S.SwinUnet(embed_dim=96, drop_path_rate=0.0,
                       cuda_graphs=cuda_graphs)
    return model.reset_parameters(torch.Generator().manual_seed(0))


@pytest.mark.card
def test_swin_unet_k3_route_against_its_twin_route(card, monkeypatch):
    """The Swin-T Swin-Unet at 224² (batch 2, bf16) on the card: every
    block routes to K3 (``swin.windows_kernel`` = ``swin.windows``, 338 a
    slice); its logits and gradients against the same model with every
    block on the twin; a graphed train step against the eager one with
    K3."""
    x = torch.randn(2, 224, 224, 1,
                    generator=torch.Generator().manual_seed(1)).to(card)
    r = torch.randn(2, 224, 224, 2,
                    generator=torch.Generator().manual_seed(2)).to(card)

    def step(model):
        model.zero_grad(set_to_none=True)
        out = model(x, generator=torch.Generator(device=card).manual_seed(3))
        (out * r).sum().backward()
        return out.detach(), {n: p.grad.detach().clone()
                              for n, p in model.named_parameters()}

    model = _swin(cuda_graphs=False).to(card).train()
    f0 = K.window_attention_forward_cuda.launches
    b0 = K.window_attention_backward_cuda.launches
    counted = GLOBAL_TIMER.counts()
    k3_out, k3_grads = step(model)
    assert K.window_attention_forward_cuda.launches - f0 == 14
    assert K.window_attention_backward_cuda.launches - b0 == 14
    now = GLOBAL_TIMER.counts()
    assert (now["swin.windows"] - counted.get("swin.windows", 0)
            == now["swin.windows_kernel"]
            - counted.get("swin.windows_kernel", 0) == 2 * 338)
    graphed = _swin(cuda_graphs=True).to(card).train()
    graphed.load_state_dict(model.state_dict())
    step(graphed)  # the capture
    g_out, g_grads = step(graphed)
    monkeypatch.setattr(S, "kernel_attends", lambda x: False)
    twin_out, twin_grads = step(model)

    assert _gap(k3_out, twin_out) < 0.01
    assert _gap(g_out, k3_out) < 0.01
    for name, g in twin_grads.items():
        if "attn" in name:
            assert _gap(k3_grads[name], g) < 0.05, name
            assert _gap(g_grads[name], k3_grads[name]) < 0.05, name
