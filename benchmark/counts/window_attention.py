"""The least work of the Swin-Unet's windowed attention (a block's
WMSA_s, from its LayerNorm'd input to its output), counted from shapes
alone, so it is the same whatever implements it.

For a block over ``tokens`` tokens of width C in ``windows`` windows of
n = m * m tokens with ``heads`` heads:
  FLOPs  2 * tokens * C * 3C (qkv) + 2 * windows * n * n * C (q k^T, all
         heads) + the same for A v + 2 * tokens * C * C (projection);
  bytes  2 bytes (bfloat16) each for the block's input and output
         (tokens * C each), the qkv and projection weights and biases
         (4C^2 + 4C), the bias B (heads * n^2) and, where the block is
         shifted, the mask (one image's windows * n^2), each read or
         written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.swin_unet import settings

BYTES = 2  # bfloat16


def block_work(tokens: int, windows: int, dim: int, heads: int,
               window: int, mask_windows: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one block's attention; ``mask_windows`` is 0 for
    an unshifted block, else the windows of one image."""
    n = window * window
    flops = (2 * tokens * dim * 3 * dim + 2 * 2 * windows * n * n * dim
             + 2 * tokens * dim * dim)
    elems = (2 * tokens * dim + 4 * dim * dim + 4 * dim + heads * n * n
             + mask_windows * n * n)
    return flops, BYTES * elems


def forward_work(cfg: Dict, batch: int) -> Dict[str, int]:
    """{'flops', 'bytes'} of every block's attention in one forward of
    ``batch`` slices: the encoder's stages and the decoder's mirrored
    ones (all but the deepest)."""
    s = settings(cfg)
    embed = int(s["SWIN_EMBED_DIM"])
    depths, heads = s["SWIN_DEPTHS"], s["SWIN_HEADS"]
    n_stages = len(depths)
    flops = nbytes = 0
    for i, (h, w, m, shift) in enumerate(s["stages"]):
        per_image = (h // m) * (w // m)
        uses = 2 if i < n_stages - 1 else 1  # encoder, and decoder mirror
        for j in range(int(depths[i])):
            shifted = bool(shift) and j % 2 == 1
            f, b = block_work(batch * h * w, batch * per_image,
                              embed * 2 ** i, int(heads[i]), m,
                              per_image if shifted else 0)
            flops += uses * f
            nbytes += uses * b
    return {"flops": flops, "bytes": nbytes}
