"""Mask-over-image rendering and training-progress figures — counterpart
of ``cmrtpu/visualization/visualize.py`` (ref: src/visualization/
Visualize.py): ``show_slice_transparent`` (:328) / ``show_2D_or_3D`` (:114)
become ``overlay_slice`` / ``plot_2d_or_3d``; the mosaics of 3D/4D volumes
(:552-705) ``plot_3d_vol`` / ``plot_4d_vol``. Figures are drawn by
matplotlib with the Agg backend and written to disk, never shown.
matplotlib is imported by ``pyplot()`` when a function draws, not when the
module is imported.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from cmrtpu_torch.utils.io_utils import ensure_dir


def pyplot():
    """matplotlib's pyplot on the Agg backend (ImportError where
    matplotlib is missing)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


# one solid color per mask channel (binary masks evaluate colormaps only at
# 1.0, which made spring/autumn indistinguishable — both yellow)
_MASK_COLORS = ((1.0, 0.2, 0.2), (0.2, 0.5, 1.0), (0.2, 1.0, 0.3),
                (1.0, 0.8, 0.1))


def _norm01(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo + 1e-8)


def overlay_slice(ax, img2d: np.ndarray, mask2d: Optional[np.ndarray] = None,
                  alpha: float = 0.4) -> None:
    """Grayscale slice + transparent per-channel mask overlay
    (ref: show_slice_transparent, Visualize.py:328)."""
    ax.imshow(_norm01(np.squeeze(img2d)), cmap="gray")
    if mask2d is not None:
        mask2d = np.asarray(mask2d)
        if mask2d.ndim == 2:  # flat labels -> channels
            values = [v for v in np.unique(mask2d) if v != 0]
            mask2d = np.stack([mask2d == v for v in values], axis=-1) if values \
                else np.zeros((*mask2d.shape, 1))
        for c in range(mask2d.shape[-1]):
            channel = np.asarray(mask2d[..., c], dtype=np.float32)
            color = _MASK_COLORS[c % len(_MASK_COLORS)]
            rgba = np.zeros((*channel.shape, 4), np.float32)
            rgba[..., :3] = color
            rgba[..., 3] = np.where(channel >= 0.5, alpha, 0.0)
            ax.imshow(rgba)
    ax.set_xticks([])
    ax.set_yticks([])


def plot_2d_or_3d(img, mask=None, path: Optional[str] = None):
    """Dispatch 2D slice vs 3D stack (ref: show_2D_or_3D, Visualize.py:114)."""
    plt = pyplot()
    img = np.squeeze(np.asarray(img))
    if img.ndim == 2:
        fig, ax = plt.subplots(figsize=(3, 3))
        overlay_slice(ax, img, mask)
    else:
        n = img.shape[0]
        fig, axes = plt.subplots(1, n, figsize=(2 * n, 2))
        axes = np.atleast_1d(axes)
        for z in range(n):
            overlay_slice(axes[z], img[z], None if mask is None else mask[z])
    if path:
        write_figure(fig, path)
    return fig


def plot_3d_vol(vol3d, mask3d=None, cols: int = 8, path: Optional[str] = None):
    """z-mosaic of a 3D volume (ref: plot_3d_vol, Visualize.py:612)."""
    plt = pyplot()
    vol3d = np.squeeze(np.asarray(vol3d))
    n = vol3d.shape[0]
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        if i < n:
            overlay_slice(ax, vol3d[i], None if mask3d is None else mask3d[i])
        ax.axis("off")
    if path:
        write_figure(fig, path)
    return fig


def plot_4d_vol(vol4d, t_step: int = 1, path: Optional[str] = None):
    """t x z mosaic of a 4D cine volume (ref: plot_4d_vol, Visualize.py:552)."""
    plt = pyplot()
    vol4d = np.squeeze(np.asarray(vol4d))
    ts = range(0, vol4d.shape[0], t_step)
    zs = vol4d.shape[1]
    fig, axes = plt.subplots(len(list(ts)), zs, figsize=(1.5 * zs, 1.5 * len(list(ts))))
    axes = np.atleast_2d(axes)
    for r, t in enumerate(range(0, vol4d.shape[0], t_step)):
        for z in range(zs):
            overlay_slice(axes[r, z], vol4d[t, z])
            axes[r, z].axis("off")
    if path:
        write_figure(fig, path)
    return fig


def save_prediction_overlays(x, y, preds, path: str, max_samples: int = 4) -> None:
    """Rows of [input | gt overlay | pred overlay] (ref CustomImageWritertf2,
    KerasCallbacks.py:386-536)."""
    plt = pyplot()
    n = min(len(x), max_samples)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n))
    axes = np.atleast_2d(axes)
    for i in range(n):
        overlay_slice(axes[i, 0], x[i])
        overlay_slice(axes[i, 1], x[i], y[i])
        overlay_slice(axes[i, 2], x[i], preds[i])
    for ax, title in zip(axes[0], ("input", "ground truth", "prediction")):
        ax.set_title(title)
    write_figure(fig, path)


def write_figure(fig, path: str) -> None:
    """Write a figure to a full path (distinct from the reference-parity
    auto-versioning save_plot in cmrtpu_torch.utils.io_utils)."""
    plt = pyplot()
    ensure_dir(os.path.dirname(os.path.abspath(path)))
    fig.tight_layout()
    fig.savefig(path, dpi=96)
    plt.close(fig)


# ---------------------------------------------------------------------------
# reference-named entry points (thin fronts over the primitives above so code
# written against the reference's Visualize API keeps working)
# ---------------------------------------------------------------------------

def my_autopct(pct) -> str:
    """Pie-chart percent filter: hide slices below 1%
    (ref: my_autopct, Visualize.py:16-22)."""
    return ("%1.0f%%" % pct) if pct > 1 else ""


def show_slice(img=None, mask=None, show: bool = True, f_size=(15, 5),
               ax=None):
    """Image + mask side overlay (ref: show_slice, Visualize.py:210)."""
    return show_slice_transparent(img, mask, show=show, f_size=f_size, ax=ax)


def _as_2d_slice(arr: np.ndarray, is_mask: bool):
    """Reference mask/image shape handling (ref: Visualize.py:355-384):
    (H, W, 1) unwraps, 4-channel masks drop the background channel,
    leading-axis stacks take the middle slice."""
    arr = np.asarray(arr)
    if arr.ndim == 3:
        if arr.shape[-1] == 1:
            return arr[..., 0]
        if arr.shape[-1] <= 4:
            return arr[..., 1:] if (is_mask and arr.shape[-1] == 4) else arr
        return arr[arr.shape[0] // 2]
    return np.squeeze(arr)


def show_slice_transparent(img=None, mask=None, show: bool = True,
                           f_size=(5, 5), ax=None, dpi: int = 300,
                           interpol: str = "none"):
    """Transparent mask-over-image rendering
    (ref: show_slice_transparent, Visualize.py:328-405). Accepts 2D,
    (H, W, C) or leading-axis 3D arrays and None for either input. Returns
    the figure when it created one (reference contract: callers savefig the
    show=False result), the given axes otherwise."""
    if img is None and mask is None:
        logging.error("No image data given")
        return None
    if mask is not None:
        mask = _as_2d_slice(mask, is_mask=True)
    base = img if img is not None \
        else np.zeros(np.asarray(mask).shape[:2], np.float32)
    base = _as_2d_slice(np.asarray(base, np.float32), is_mask=False)
    if base.ndim == 3:  # (H, W, C) image: first channel, grayscale
        base = base[..., 0]
    created = ax is None
    if created:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=f_size, dpi=dpi)
    overlay_slice(ax, base, mask)
    if created and show:
        plt.show()
    return ax.figure if created else ax


def show_2D_or_3D(img, mask=None, path=None):
    """(ref: show_2D_or_3D, Visualize.py:114)"""
    return plot_2d_or_3d(img, mask, path=path)
