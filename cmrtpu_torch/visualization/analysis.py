"""Analysis/eval figures — the second half of the visualization layer.

Rebuild of the evaluation-side plots of the reference
(ref: src/visualization/Visualize.py):
  * plot_dice_per_slice_bar (:38)   — per-slice dice bars for a gt/pred pair
  * create_eval_plot        (:164)  — violin panel over dice/HD/volume dfs
  * bland_altman_metric_plot(:408)  — Bland-Altman agreement per metric
  * plot_confusion_matrix   (:493)  — normalisable confusion matrix
  * plot_value_histogram    (:705)  — intensity histogram of a volume
  * create_quiver_plot      (:764)  — 2D flow-field quiver
  * plot_radar_chart        (:833)  — per-patient metric radar
  * show_phases / _transpose(:886,:948) — ED/ES phase matrices

All figures use the Agg backend and are returned (and optionally written);
nothing calls plt.show(). The counterpart of
``cmrtpu/visualization/analysis.py`` without pandas: the tables are a dict
of column -> values or a list of row dicts, and matplotlib is imported
when a function draws.
"""

from __future__ import annotations

import math
import numbers
from typing import Dict, List, Optional, Sequence

import numpy as np

from cmrtpu_torch.visualization.visualize import pyplot, write_figure


def _missing(v) -> bool:
    """None or a float NaN: what pandas' ``dropna`` drops."""
    return v is None or (isinstance(v, (float, np.floating))
                         and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, (numbers.Number, np.number)) \
        and not isinstance(v, (bool, np.bool_))


def as_columns(table) -> Dict[str, List]:
    """A table as column -> values: a mapping of columns (a pandas frame
    too) or a list of row dicts, whose columns come in order of first
    appearance and whose absent cells are None."""
    if hasattr(table, "items"):
        return {str(k): list(v) for k, v in table.items()}
    rows = list(table)
    names: List[str] = []
    for row in rows:
        names += [k for k in row if k not in names]
    return {k: [row.get(k) for row in rows] for k in names}


def _dice(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a) > 0.5, np.asarray(b) > 0.5
    denom = a.sum() + b.sum()
    return 1.0 if denom == 0 else 2.0 * float((a & b).sum()) / float(denom)


def plot_dice_per_slice_bar(gt: np.ndarray, pred: np.ndarray,
                            save_path: Optional[str] = None, m_fn=None):
    """Bar chart of per-z-slice dice between a gt and prediction volume
    (ref: plot_dice_per_slice_bar, Visualize.py:38-111)."""
    plt = pyplot()
    m_fn = m_fn or _dice
    scores = [m_fn(gt[z], pred[z]) for z in range(len(gt))]
    fig, ax = plt.subplots(figsize=(max(4, len(scores) * 0.5), 3))
    colors = ["tab:green" if s >= 0.8 else "tab:orange" if s >= 0.5
              else "tab:red" for s in scores]
    ax.bar(range(len(scores)), scores, color=colors)
    ax.set_xlabel("z slice")
    ax.set_ylabel("dice")
    ax.set_ylim(0, 1)
    if save_path:
        write_figure(fig, save_path)
    return fig, scores


def create_eval_plot(df_dice, df_hd=None, df_vol=None, eval_name: str = "",
                     path: Optional[str] = None,
                     names: Sequence[str] = ("dice", "hausdorff", "volume")):
    """Violin panel over per-label metric dataframes
    (ref: create_eval_plot, Visualize.py:164-207). Each table is a dict of
    column -> values or a list of row dicts; a violin skips its column's
    None/NaN cells; ``names`` override the panel titles."""
    plt = pyplot()
    frames = list(zip(names, (df_dice, df_hd, df_vol)))
    frames = [(name, as_columns(df)) for name, df in frames if df is not None]
    fig, axes = plt.subplots(1, len(frames), figsize=(5 * len(frames), 4))
    axes = np.atleast_1d(axes)
    for ax, (name, cols) in zip(axes, frames):
        data = violin_data(cols)
        if all(len(d) for d in data):
            ax.violinplot(data, showmeans=True)
        ax.set_xticks(range(1, len(cols) + 1))
        ax.set_xticklabels(list(cols), rotation=30)
        ax.set_title(f"{eval_name} {name}".strip())
    if path:
        write_figure(fig, path)
    return fig


def violin_data(cols: Dict[str, List]) -> List[np.ndarray]:
    """One array per column of its cells that are not None/NaN."""
    return [np.asarray([v for v in values if not _missing(v)])
            for values in cols.values()]


def bland_altman_metric_plot(data1: Sequence[float], data2: Sequence[float],
                             ax=None, label: str = ""):
    """Bland-Altman agreement plot: mean vs difference with ±1.96 SD limits
    (ref: bland_altman_metric_plot, Visualize.py:408-490)."""
    plt = pyplot()
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(5, 4))
    else:
        fig = ax.figure
    data1 = np.asarray(data1, np.float64)
    data2 = np.asarray(data2, np.float64)
    mean = (data1 + data2) / 2.0
    diff = data1 - data2
    md, sd = float(np.mean(diff)), float(np.std(diff))
    ax.scatter(mean, diff, s=12, alpha=0.7)
    ax.axhline(md, color="gray", linestyle="-")
    ax.axhline(md + 1.96 * sd, color="gray", linestyle="--")
    ax.axhline(md - 1.96 * sd, color="gray", linestyle="--")
    ax.set_xlabel(f"mean {label}")
    ax.set_ylabel(f"difference {label}")
    return fig, (md, sd)


def plot_confusion_matrix(y_true, y_pred, classes: Sequence[str],
                          normalize: bool = False, title: Optional[str] = None,
                          path: Optional[str] = None):
    """Confusion matrix heatmap (ref: plot_confusion_matrix,
    Visualize.py:493-549)."""
    plt = pyplot()
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    n = len(classes)
    cm = np.zeros((n, n), np.float64)
    for t, p in zip(y_true, y_pred):
        cm[int(t), int(p)] += 1
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-12)
    fig, ax = plt.subplots(figsize=(4 + n * 0.3, 4 + n * 0.3))
    im = ax.imshow(cm, interpolation="nearest", cmap="Blues")
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(n)); ax.set_xticklabels(classes, rotation=45)
    ax.set_yticks(range(n)); ax.set_yticklabels(classes)
    fmt = ".2f" if normalize else ".0f"
    thresh = cm.max() / 2.0 if cm.size else 0.5
    for i in range(n):
        for j in range(n):
            ax.text(j, i, format(cm[i, j], fmt), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_ylabel("True label"); ax.set_xlabel("Predicted label")
    if title:
        ax.set_title(title)
    if path:
        write_figure(fig, path)
    return fig, cm


def plot_value_histogram(nda: np.ndarray, f_name: Optional[str] = None,
                         bins: int = 100):
    """Intensity histogram with .50/.75/.99 quantile markers
    (ref: plot_value_histogram, Visualize.py:705-761)."""
    plt = pyplot()
    flat = np.asarray(nda).reshape(-1)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.hist(flat, bins=bins)
    for q, color in ((0.5, "tab:green"), (0.75, "tab:orange"), (0.99, "tab:red")):
        ax.axvline(float(np.quantile(flat, q)), color=color, linestyle="--",
                   label=f"{q:.2f} quantile")
    ax.legend()
    ax.set_xlabel("intensity"); ax.set_ylabel("count")
    if f_name:
        write_figure(fig, f_name)
    return fig


def create_quiver_plot(flowfield_2d: np.ndarray, ax=None, n: int = 5,
                       scale: float = 0.3, linewidth: float = 0.5):
    """Down-sampled quiver of a [H, W, 2] displacement field
    (ref: create_quiver_plot, Visualize.py:764-830)."""
    plt = pyplot()
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(5, 5))
    else:
        fig = ax.figure
    field = np.asarray(flowfield_2d)
    ys, xs = np.mgrid[0:field.shape[0]:n, 0:field.shape[1]:n]
    u = field[::n, ::n, 1]
    v = field[::n, ::n, 0]
    ax.quiver(xs, ys, u, -v, angles="xy", scale_units="xy",
              scale=1.0 / max(scale, 1e-6), linewidth=linewidth)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    return fig


def radar_values(table, index: int = 0):
    """(labels, values) of row ``index``: its numeric, non-bool cells in
    column order."""
    cols = as_columns(table)
    cells = [(k, v[index]) for k, v in cols.items() if _is_number(v[index])]
    return [k for k, _ in cells], [float(v) for _, v in cells]


def plot_radar_chart(df, index: int = 0, ax=None):
    """Radar chart of one table row's numeric metrics
    (ref: plot_radar_chart, Visualize.py:833-883); ``df`` a dict of
    column -> values or a list of row dicts."""
    plt = pyplot()
    labels, values = radar_values(df, index)
    angles = np.linspace(0, 2 * np.pi, len(labels), endpoint=False).tolist()
    values += values[:1]
    angles += angles[:1]
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(5, 5), subplot_kw={"projection": "polar"})
    else:
        fig = ax.figure
    ax.plot(angles, values)
    ax.fill(angles, values, alpha=0.25)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(labels, fontsize=8)
    return fig


def show_phases(gt: np.ndarray, pred: Optional[np.ndarray] = None,
                phase_names: Sequence[str] = ("ED", "MS", "ES", "PF", "MD"),
                path: Optional[str] = None):
    """Phase-indicator matrix [phases x timesteps], gt (and pred) as
    scatter rows (ref: show_phases, Visualize.py:886-945)."""
    plt = pyplot()
    gt = np.atleast_2d(np.asarray(gt))
    fig, ax = plt.subplots(figsize=(8, 2 + 0.3 * gt.shape[0]))
    for p in range(gt.shape[0]):
        ts = np.nonzero(gt[p])[0]
        ax.scatter(ts, np.full(len(ts), p), marker="s", color="tab:blue",
                   label="gt" if p == 0 else None)
    if pred is not None:
        pred = np.atleast_2d(np.asarray(pred))
        for p in range(pred.shape[0]):
            ts = np.nonzero(pred[p])[0]
            ax.scatter(ts, np.full(len(ts), p), marker="x", color="tab:red",
                       label="pred" if p == 0 else None)
    ax.set_yticks(range(gt.shape[0]))
    ax.set_yticklabels(list(phase_names)[:gt.shape[0]])
    ax.set_xlabel("timestep")
    ax.legend(loc="upper right")
    if path:
        write_figure(fig, path)
    return fig


def show_phases_transpose(gt: np.ndarray, pred: Optional[np.ndarray] = None,
                          **kwargs):
    """Transposed variant (ref: show_phases_transpose, Visualize.py:948-1004)."""
    gt = np.atleast_2d(np.asarray(gt)).T
    pred_t = None if pred is None else np.atleast_2d(np.asarray(pred)).T
    return show_phases(gt, pred_t, **kwargs)
