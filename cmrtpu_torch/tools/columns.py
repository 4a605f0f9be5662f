"""Column statistics of evaluation tables, as pandas computes them on a
``df_eval.csv`` column, for the A/B tools, the quickstart and
``analyze_results`` (cmrtpu's tools call pandas' ``mean``/``std``).

A cell counts when it parses to a float that is not NaN (an empty csv
cell, None, NaN and text are skipped, as pandas skips NaN and
``to_numeric(errors="coerce")`` turns text into NaN). The sums follow
pandas' ``nanmean``/``nanvar``: the skipped cells are summed as zeros.
"""

from __future__ import annotations

import csv
import json
import math
from typing import Dict, List, Sequence

import numpy as np

# the localisation columns the A/B tools print
COLS = ("mdists_ant_gtpred", "mdists_inf_gtpred",
        "tpr_ant_point_th15", "ppv_ant_point_th15",
        "tpr_inf_point_th15", "ppv_inf_point_th15")


def to_float(v) -> float:
    """A cell as a float, NaN where it does not parse."""
    if v is None or isinstance(v, bool):
        return math.nan
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def _masked(values: Sequence):
    arr = np.array([to_float(v) for v in values], np.float64)
    mask = np.isnan(arr)
    return np.where(mask, 0.0, arr), mask


def numeric(values: Sequence) -> List[float]:
    """The cells that count, as floats, in order."""
    return [f for f in map(to_float, values) if not math.isnan(f)]


def mean(values: Sequence) -> float:
    """pandas' ``Series.mean()`` of the cells (NaN when none counts)."""
    arr, mask = _masked(values)
    count = int((~mask).sum())
    return float(arr.sum(dtype=np.float64) / count) if count else math.nan


def sd(values: Sequence, ddof: int = 1) -> float:
    """pandas' ``Series.std()``: the sample standard deviation (ddof 1)
    of the cells (NaN with fewer than ddof + 1)."""
    arr, mask = _masked(values)
    count = int((~mask).sum())
    if count - ddof <= 0:
        return math.nan
    avg = arr.sum(dtype=np.float64) / count
    sqr = np.where(mask, 0.0, (avg - arr) ** 2)
    return float(np.sqrt(sqr.sum(dtype=np.float64) / (count - ddof)))


def read_columns(path: str) -> Dict[str, List[str]]:
    """A csv file as column -> its cells (text)."""
    with open(path, newline="", encoding="utf-8") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], rows[1:]
    return {name: [r[i] if i < len(r) else "" for r in body]
            for i, name in enumerate(header)}


def report_ab(title: str, names: Sequence[str], tables: Sequence[Dict],
              csv_paths: Sequence[str], cols: Sequence[str] = COLS,
              fmt: str = "8.3f", label: int = 24) -> Dict:
    """Print the A/B lines of two evaluation tables (column -> values) as
    cmrtpu's tools print them, the two df_eval.csv paths, and one JSON
    line of the unrounded means; returns that JSON's dict:
    ``{"means": {name: {col: mean}}, "df_eval": {name: path}}``."""
    a, b = names
    means = {a: {}, b: {}}
    print(f"\n=== {title} ===")
    for c in cols:
        if c in tables[0] and c in tables[1]:
            means[a][c], means[b][c] = (mean(t[c]) for t in tables)
            print(f"  {c:{label}s} {a} {means[a][c]:{fmt}}   "
                  f"{b} {means[b][c]:{fmt}}")
    width = max(len(a), len(b)) + len(" df_eval:")
    for name, path in zip(names, csv_paths):
        print(f"{name + ' df_eval:':{width}} {path}")
    out = {"means": means, "df_eval": dict(zip(names, csv_paths))}
    print(json.dumps(out), flush=True)
    return out
