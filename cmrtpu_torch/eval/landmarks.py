"""Insertion-point extraction + geometric metrics.

Parity with the metric primitives of src/models/evaluate_cv.py and the
contour-walk extraction of src/data/Preprocess.py:15-120:

  * ``get_mean_rvip_2d``      per-label centre of mass, ``both_only`` flag
                              (ref: evaluate_cv.py:418-442)
  * ``get_ip_from_2dmask``    anti-clockwise MYO-contour walk around the
                              septum for LV/MYO/RV masks (ref: Preprocess.py:15-89)
  * angles/distances/TPR/PPV  (ref: evaluate_cv.py:267-353, :508-595)

Coordinates are (y, x) tuples like the reference; distances are multiplied by
the in-plane spacing where mm values are required. The port's own copy of
``cmrtpu/eval/landmarks.py``, held equal to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

from ast import literal_eval
from math import atan2, degrees
from typing import List, Optional, Sequence, Tuple

import numpy as np

Point = Optional[List[float]]


# ---------------------------------------------------------------------------
# centre-of-mass IP extraction from RVIP label masks
# ---------------------------------------------------------------------------

def get_mean_rvip_2d(nda_2d: np.ndarray, both_only: bool = False
                     ) -> Tuple[Point, Point]:
    """Per-label CoM of a 2D mask; value 1 = anterior, 2 = inferior
    (ref: evaluate_cv.py:418-442)."""
    assert len(nda_2d.shape) == 2, f"invalid shape: {nda_2d.shape}"
    points = {"1": None, "2": None}
    labels = np.unique(nda_2d)[1:]  # ignore background
    if both_only and len(labels) != 2:
        return points["1"], points["2"]
    for value in labels:
        ys, xs = np.where(nda_2d == value)
        points[str(int(value))] = [float(ys.mean()), float(xs.mean())]
    return points["1"], points["2"]


def get_ip_from_rvip_mask_3d(msk_3d: np.ndarray, keepdim: bool = False,
                             both_only: bool = True
                             ) -> Tuple[List[Point], List[Point]]:
    """(ref: evaluate_cv.py:389-416)"""
    first_ips, second_ips = [], []
    for msk2d in msk_3d:
        first, second = get_mean_rvip_2d(msk2d, both_only=both_only)
        if (first is not None and second is not None) or keepdim:
            first_ips.append(first)
            second_ips.append(second)
    return first_ips, second_ips


def get_ip_from_rvip_file(f_name: str, keepdim: bool = False,
                          both_only: bool = True):
    from cmrtpu_torch.io import read_image
    nda = read_image(f_name).array
    return get_ip_from_rvip_mask_3d(nda, keepdim=keepdim, both_only=both_only)


# ---------------------------------------------------------------------------
# contour-walk IP extraction from LV/MYO/RV ventricle masks
# ---------------------------------------------------------------------------

def get_ip_from_2dmask(nda: np.ndarray, rev: bool = False
                       ) -> Tuple[Optional[tuple], Optional[tuple]]:
    """Insertion points from an LV/MYO/RV mask (labels: RV=1, MYO=2, LV=3).

    The MYO outer contour splits into two arcs: points that also lie on the
    outer contour of the combined heart mask (the free wall), and points that
    don't (the septal arc facing the RV). Walking the MYO contour in OpenCV's
    traversal order, the free-wall point right before the walk enters the
    septal arc is the anterior IP; the first free-wall point after leaving it
    is the inferior IP. Numerically identical to the reference's cv2-based
    walk (ref: src/data/Preprocess.py:15-89) but OpenCV-free: contours come
    from the first-party Suzuki-Abe tracer (eval/contours.py)."""
    from cmrtpu_torch.eval.contours import find_external_contours

    anterior, inferior = None, None
    if np.isin(1, nda) and np.isin(2, nda):
        myo_contours = find_external_contours(nda == 2)
        heart_contours = find_external_contours(
            (nda == 1) | (nda == 2) | (nda == 3))
        if myo_contours and heart_contours:
            walk = myo_contours[0]
            free_wall = set(heart_contours[0])
            on_wall = [p in free_wall for p in walk]

            # inferior: first free-wall point after the first septal point
            septal = [i for i, w in enumerate(on_wall) if not w]
            if septal:
                inferior = next((walk[i] for i in range(septal[0] + 1,
                                                        len(walk))
                                 if on_wall[i]), None)
            # anterior: free-wall point immediately preceding the first
            # septal point that has free-wall points before it
            last_wall = None
            for i, w in enumerate(on_wall):
                if w:
                    last_wall = walk[i]
                elif last_wall is not None:
                    anterior = last_wall
                    break
            if anterior is None and inferior is not None:
                # the walk opened inside the septal arc and never re-entered
                # it: cyclically, the anterior IP is the walk's last
                # free-wall point
                anterior = last_wall
        if rev and (anterior is not None) and (inferior is not None):
            anterior = (anterior[1], anterior[0])
            inferior = (inferior[1], inferior[0])
    return anterior, inferior


def get_ip_from_mask_3d(msk_3d: np.ndarray, keepdim: bool = False,
                        rev: bool = False):
    """(ref: src/data/Preprocess.py:92-120)"""
    first_ips, second_ips = [], []
    for msk2d in msk_3d:
        try:
            first, second = get_ip_from_2dmask(msk2d, rev=rev)
            if (first is not None) and (second is not None) or keepdim:
                first_ips.append(first)
                second_ips.append(second)
        except Exception as e:  # parity: tolerate degenerate slices
            print(str(e))
    return first_ips, second_ips


def get_ip_from_ventriclemsk_file(f_name: str, keepdim: bool = False,
                                  yx_coordinates: bool = True):
    from cmrtpu_torch.io import read_image
    nda = read_image(f_name).array
    return get_ip_from_mask_3d(nda, keepdim=keepdim, rev=yx_coordinates)


# ---------------------------------------------------------------------------
# geometric metrics
# ---------------------------------------------------------------------------

def get_angle2x(p1, p2) -> Optional[float]:
    """Angle (deg, anti-clockwise from x-axis, wrapped to [0, 360)) of the
    anterior->inferior line (ref: evaluate_cv.py:508-536)."""
    angle = None
    try:
        if p1 is not None and p2 is not None \
                and np.isfinite(p1).all() and np.isfinite(p2).all():
            y1, x1, y2, x2 = p1[0], p1[1], p2[0], p2[1]
            angle = degrees(atan2(y2 - y1, x2 - x1))
            if angle < 0:
                angle = 360 + angle
    except Exception as e:
        print(f"p1: {p1}, p2: {p2}")
        raise e
    return angle


def get_angles2x(rvips) -> np.ndarray:
    ants, infs = rvips
    return np.array([get_angle2x(a, b) if (a is not None and b is not None)
                     else None for a, b in zip(ants, infs)])


def get_dist(p1, p2) -> Optional[float]:
    if p1 is None or p2 is None:
        return None
    return float(np.linalg.norm(np.array(p1, dtype=float)
                                - np.array(p2, dtype=float)))


def calc_mean_ip(ips_list) -> Tuple:
    """Mean anterior/inferior over slices, NaN if none (ref: :113-120)."""
    mant, minf = np.nan, np.nan
    if isinstance(ips_list, str):
        ips_list = literal_eval(ips_list)
    ants, infs = ips_list
    ants = [e for e in ants if e is not None]
    infs = [e for e in infs if e is not None]
    if len(ants) > 0 and len(infs) > 0:
        mant = np.array(ants, dtype=float).mean(axis=0)
        minf = np.array(infs, dtype=float).mean(axis=0)
    return mant, minf


def get_diff(a, b) -> Optional[float]:
    if a is None or b is None:
        return None
    return abs(a - b)


def get_differences(angles1, angles2) -> np.ndarray:
    return np.array([abs(a - b) if a is not None and b is not None else None
                     for a, b in zip(angles1, angles2)])


def get_distances(ips1, ips2, spacing: float = 1.0,
                  threshold: Optional[float] = None):
    """Per-slice mm distances, None-preserving, optional threshold filter
    (ref: evaluate_cv.py:549-561)."""
    vol1_ants, vol1_infs = ips1
    vol2_ants, vol2_infs = ips2
    ant = [get_dist(a, b) * spacing if a is not None and b is not None else None
           for a, b in zip(vol1_ants, vol2_ants)]
    inf = [get_dist(a, b) * spacing if a is not None and b is not None else None
           for a, b in zip(vol1_infs, vol2_infs)]
    if threshold is not None:
        ant = [d if d is not None and d <= threshold else None for d in ant]
        inf = [d if d is not None and d <= threshold else None for d in inf]
    return np.array(ant), np.array(inf)


def get_mean_dist(dists) -> Optional[float]:
    dists = np.array(dists)
    dists = dists[dists != None]  # noqa: E711 — object-array None filter
    return float(np.mean(dists)) if len(dists) > 0 else None


def get_distances_upper_bound(ips1, ips2, spacing: float = 1.0, dim: int = 224):
    """FN slices get the distance to the farthest image corner
    (ref: evaluate_cv.py:572-595). ips1 = GT, ips2 = pred."""
    vol1_ants, vol1_infs = ips1
    vol2_ants, vol2_infs = ips2
    ant = [None] * len(vol1_ants)
    inf = [None] * len(vol1_infs)

    def upper_bound(point):
        return max(get_dist(point, c) * spacing
                   for c in [(0, 0), (0, dim), (dim, 0), (dim, dim)])

    for i, (a, b) in enumerate(zip(vol1_ants, vol2_ants)):
        if a is not None and b is not None:
            ant[i] = get_dist(a, b) * spacing
        elif a is not None:
            ant[i] = upper_bound(a)
    for i, (a, b) in enumerate(zip(vol1_infs, vol2_infs)):
        if a is not None and b is not None:
            inf[i] = get_dist(a, b) * spacing
        elif a is not None:
            inf[i] = upper_bound(a)
    return np.array(ant), np.array(inf)


def _parse_ips(ips):
    return literal_eval(ips) if isinstance(ips, str) else ips


def _detection_counts(gt_pts, pred_pts, thresh: float, spacing: float):
    """Per-slice detection outcomes for one landmark: (hits, misses, far,
    spurious) = within-threshold pairs, gt-without-pred, beyond-threshold
    pairs, pred-without-gt."""
    hits = misses = far = spurious = 0
    for g, p in zip(gt_pts, pred_pts):
        if g is not None and p is not None:
            if get_dist(g, p) * spacing <= thresh:
                hits += 1
            else:
                far += 1
        elif g is not None:
            misses += 1
        elif p is not None:
            spurious += 1
    return hits, misses, far, spurious


def calc_tpr_thresh(gt, pred, thresh: float = 1000, spacing: float = 1.0):
    """Slice-wise TPR per landmark (anterior, inferior) with a distance
    threshold (ref: evaluate_cv.py:267-307). Matching the reference exactly:
    beyond-threshold detections count neither as TP nor FN, and a landmark
    with zero hits scores 0."""
    out = []
    for gt_pts, pred_pts in zip(_parse_ips(gt), _parse_ips(pred)):
        hits, misses, _, _ = _detection_counts(gt_pts, pred_pts, thresh,
                                               spacing)
        out.append(hits / (hits + misses) if hits > 0 else 0)
    return tuple(out)


def calc_ppv_thresh(gt, pred, thresh: float = 1000, spacing: float = 1.0):
    """Slice-wise PPV per landmark (anterior, inferior); beyond-threshold
    hits and spurious detections both count as FP
    (ref: evaluate_cv.py:310-353)."""
    out = []
    for gt_pts, pred_pts in zip(_parse_ips(gt), _parse_ips(pred)):
        hits, _, far, spurious = _detection_counts(gt_pts, pred_pts, thresh,
                                                   spacing)
        false_pos = far + spurious
        out.append(hits / (hits + false_pos) if hits > 0 else 0)
    return tuple(out)
