"""Batched histogram matching on tensors — counterpart of
``cmrtpu/pipeline/histmatch.py`` (Var.1 of the published experiments: about
10% of the training examples are matched against a random cached slice,
ref: src/data/Generators.py:350-368).

Two matchers over [B, H, W] sources and references, one pair per row:

  * ``match_histograms_binned`` (the default, ``HIST_MATCHING_BINS`` 2048):
    binned CDFs and an inverse-CDF table. cmrtpu counts each CDF with a
    [bins, pixels] compare-reduce; here per-row histograms (one integer
    ``index_add_``, indices offset by row) and a ``cumsum`` give the same
    integer counts, and ``searchsorted(side='left')`` over the reference
    CDF gives the same first bin reaching each level. The bin index
    ``(x - lo) / scale * bins`` is formed in the same float32 order, so the
    indices are the reference's.
  * ``match_histograms_exact`` (``HIST_MATCHING_BINS: 0``): sorted-quantile
    mapping, skimage's semantics with static shapes.

Neither is a Pallas kernel in the reference (XLA ops there); both stay
torch ops here. ``hist_quota`` and ``gated_match`` are the cached loops'
gate (``cmrtpu/train/device_cache.py:391-427``). ``match_2d_on_nd`` is a
copy of cmrtpu's numpy matcher, which the host-finalized batch
(``DataGenerator.__getitem__``) uses.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C


def match_histograms(source: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Monochannel histogram matching on the host, skimage's quantile
    mapping (cmrtpu's numpy ``match_histograms``)."""
    src = np.asarray(source)
    ref = np.asarray(reference)
    src_values, src_idx, src_counts = np.unique(src.reshape(-1),
                                                return_inverse=True,
                                                return_counts=True)
    ref_values, ref_counts = np.unique(ref.reshape(-1), return_counts=True)
    src_quantiles = np.cumsum(src_counts) / src.size
    ref_quantiles = np.cumsum(ref_counts) / ref.size
    interp = np.interp(src_quantiles, ref_quantiles, ref_values)
    return interp[src_idx].reshape(src.shape).astype(np.float32)


def match_2d_on_nd(nda: np.ndarray, avg: np.ndarray) -> np.ndarray:
    """2D matching per slice of a 2D/3D/4D array (ref:
    Preprocess.py:353-379)."""
    nda = np.asarray(nda, dtype=np.float32)
    if nda.ndim == 2:
        return match_histograms(nda, avg)
    if nda.ndim == 3:
        return np.stack([match_histograms(s, avg) for s in nda])
    if nda.ndim == 4:
        return np.stack([[match_histograms(s, avg) for s in vol]
                         for vol in nda])
    return nda


def _binned_cdf(x: torch.Tensor, bins: int, exclude_zeros: bool):
    """Per row of [B, P]: (cdf [B, bins] f32, lo [B], scale [B], bin
    indices [B, P] int64). With ``exclude_zeros`` exact zeros enter neither
    the counts nor lo/hi."""
    if exclude_zeros:
        valid = x != 0.0
        n_valid = torch.clamp(valid.sum(dim=1).float(), min=1.0)
        lo = torch.where(valid, x, math.inf).amin(dim=1)
        hi = torch.where(valid, x, -math.inf).amax(dim=1)
    else:
        valid = None
        n_valid = torch.full((x.shape[0],), float(x.shape[1]),
                             device=x.device)
        lo, hi = x.amin(dim=1), x.amax(dim=1)
    scale = torch.clamp(hi - lo, min=1e-12)
    t = (x - lo[:, None]) / scale[:, None] * bins
    # truncation toward zero, then clip, as astype(int32) + clip; the float
    # clamp first keeps +-inf (an all-zero row) out of the integer cast
    idx = t.clamp(-1.0, float(bins)).to(torch.int64).clamp(0, bins - 1)
    # out-of-histogram pixels go to an extra bin per row that is cut off;
    # an integer index_add_ is bincount without its size read back to the
    # host (a sync inside the train step)
    counted = idx if valid is None else torch.where(valid, idx, bins)
    rows = torch.arange(x.shape[0], device=x.device)[:, None] * (bins + 1)
    flat = (counted + rows).reshape(-1)
    counts = torch.zeros(x.shape[0] * (bins + 1), dtype=torch.int64,
                         device=x.device).index_add_(
        0, flat, torch.ones_like(flat))
    cdf = counts.reshape(x.shape[0], bins + 1)[:, :bins].cumsum(dim=1)
    return cdf.float() / n_valid[:, None], lo, scale, idx


def match_histograms_binned(source: torch.Tensor, reference: torch.Tensor,
                            bins: int = 4096,
                            exclude_zeros: bool = False) -> torch.Tensor:
    """Match each source row of [B, ...] to the reference row of the same
    index by binned CDFs (ref: match_histograms_binned_jax). With
    ``exclude_zeros`` exact zeros (the padded cache's border) stay zero and
    enter no histogram."""
    src = source.float()
    flat = src.reshape(src.shape[0], -1)
    rflat = reference.float().reshape(reference.shape[0], -1)
    src_cdf, _, _, src_idx = _binned_cdf(flat, bins, exclude_zeros)
    ref_cdf, ref_lo, ref_scale, _ = _binned_cdf(rflat, bins, exclude_zeros)

    # invert the reference CDF once: level (k+1)/bins -> reference value
    levels = (torch.arange(bins, dtype=torch.float32, device=src.device)
              + 1.0) / bins
    levels = levels.expand(src.shape[0], bins).contiguous()
    pos = torch.searchsorted(ref_cdf.contiguous(), levels,
                             right=False).clamp(0, bins - 1)
    before = torch.gather(ref_cdf, 1, torch.clamp(pos - 1, min=0))
    prev = torch.where(pos > 0, before, 0.0)
    frac = torch.clamp((levels - prev) / torch.clamp(
        torch.gather(ref_cdf, 1, pos) - prev, min=1e-12), 0.0, 1.0)
    inverse_table = ref_lo[:, None] + (pos.float() + frac) \
        * (ref_scale / bins)[:, None]

    quantiles = torch.gather(src_cdf, 1, src_idx)
    level_idx = ((quantiles * bins).to(torch.int64) - 1).clamp(0, bins - 1)
    matched = torch.gather(inverse_table, 1, level_idx)
    if exclude_zeros:
        matched = torch.where(flat != 0.0, matched, 0.0)
    return matched.reshape(src.shape)


def match_histograms_exact(source: torch.Tensor,
                           reference: torch.Tensor) -> torch.Tensor:
    """Sorted-quantile matching per row (ref: match_histograms_jax): each
    source pixel's CDF position (count of values <= it, so ties map alike)
    is read out of the sorted reference at the same quantile, with linear
    interpolation."""
    src = source.float()
    flat = src.reshape(src.shape[0], -1)
    n_src = flat.shape[1]
    ref_sorted = reference.float().reshape(reference.shape[0], -1).sort(
        dim=1).values
    n_ref = ref_sorted.shape[1]
    counts_le = torch.searchsorted(flat.sort(dim=1).values, flat, right=True)
    quantiles = counts_le.float() / float(n_src)
    positions = torch.clamp(quantiles * n_ref - 1.0, 0.0, n_ref - 1.0)
    lo = torch.floor(positions).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n_ref - 1)
    w = positions - lo
    matched = torch.gather(ref_sorted, 1, lo) * (1.0 - w) \
        + torch.gather(ref_sorted, 1, hi) * w
    return matched.reshape(src.shape)


def hist_quota(prob: float, batch: int) -> Tuple[int, float]:
    """(candidate count, gate probability) that match prob * batch examples
    per batch in expectation: ceil(prob * batch) candidates, each gated with
    probability prob * batch / ceil(prob * batch)."""
    expect = float(prob) * int(batch)
    if expect <= 0:
        return 0, 1.0
    count = int(math.ceil(expect))
    return count, expect / count


def hist_match_setup(config: Dict, augment: bool
                     ) -> Tuple[Optional[Callable], float]:
    """(matcher, probability): the matcher is None unless HIST_MATCHING and
    AUGMENT are both on. HIST_MATCHING_BINS > 0 (default 2048) selects the
    binned matcher with exact zeros excluded (the cache holds zero-padded
    slices), 0 the exact one."""
    prob = float(C.get(config, "HIST_MATCHING_PROB", 0.1))
    if not (bool(C.get(config, "HIST_MATCHING", False)) and augment):
        return None, prob
    bins = int(C.get(config, "HIST_MATCHING_BINS", 2048))
    if bins > 0:
        return (lambda s, r: match_histograms_binned(
            s, r, bins=bins, exclude_zeros=True)), prob
    return match_histograms_exact, prob


def gated_match(match_fn: Callable, imgs: torch.Tensor,
                cache_x: torch.Tensor, sel: torch.Tensor,
                ref_idx: torch.Tensor,
                gate: Optional[torch.Tensor]) -> torch.Tensor:
    """Match the rows ``sel`` of ``imgs`` against the cached rows
    ``ref_idx``; a candidate whose ``gate`` is False keeps its image
    (``gate`` None: all are matched). Returns a new batch."""
    cand = imgs.index_select(0, sel)
    refs = cache_x.index_select(0, ref_idx).float()
    matched = match_fn(cand, refs)
    if gate is not None:
        matched = torch.where(
            gate.reshape((-1,) + (1,) * (imgs.dim() - 1)), matched, cand)
    out = imgs.clone()
    out[sel] = matched
    return out


def draw_match(generator: torch.Generator, batch: int, n_cache: int,
               quota: int, gate_p: float, first_rows: bool = False):
    """The draws of one step: ``quota`` candidates by a random permutation
    of the batch (the first ``quota`` rows with ``first_rows``, as cmrtpu's
    sharded and explicit-collectives steps take them), one random cached
    row for each, and the gates (None when ``gate_p`` is 1), all from
    ``generator``."""
    dev = generator.device
    sel = torch.arange(quota, device=dev) if first_rows else torch.randperm(
        batch, generator=generator, device=dev)[:quota]
    ref_idx = torch.randint(0, n_cache, (quota,), generator=generator,
                            device=dev)
    gate = None
    if gate_p < 1.0:
        gate = torch.rand((quota,), generator=generator, device=dev) < gate_p
    return sel, ref_idx, gate
