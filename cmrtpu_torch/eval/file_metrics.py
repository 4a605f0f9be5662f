"""File-level landmark comparisons — counterpart of
``cmrtpu/eval/file_metrics.py`` (ref: src/models/evaluate_cv.py:69-266),
over the port's own ``eval/landmarks.py``.

These compare two mask volumes (or two files) directly: per-slice or
mean-insertion-point distances and septum-angle statistics, each accepting
either RVIP label masks (values 1/2) or LV/MYO/RV ventricle masks (contour
walk). ``get_angles_as_df`` and ``get_dist_as_df`` return rows (one dict
per file pair) with cmrtpu's DataFrame columns in its order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from cmrtpu_torch.eval.landmarks import (calc_mean_ip, get_angles2x,
                                         get_distances, get_ip_from_mask_3d,
                                         get_ip_from_rvip_mask_3d)
from cmrtpu_torch.io import read_image


def isvalid(point) -> bool:
    """A point exists and has no NaN coordinates (ref: evaluate_cv.py:69-73)."""
    return point is not None and not np.any(np.isnan(point))


def _extract_ips(vol: np.ndarray, ismsk: bool):
    """keepdim insertion points; ventricle masks go through the contour walk
    with (y, x) ordering like the CoM extractor (ref: :142-152, :185-189)."""
    if ismsk:
        return get_ip_from_mask_3d(vol, keepdim=True, rev=True)
    return get_ip_from_rvip_mask_3d(vol, keepdim=True)


def _mean_ips(ants: Sequence, infs: Sequence) -> Tuple[List, List]:
    """Slice-wise points collapsed to one mean point each
    (``calc_mean_ip``; ref: :156-165); NaN for a landmark that never
    appears."""
    mant, minf = calc_mean_ip((list(ants), list(infs)))
    return [mant], [minf]


def calc_distances(vol1: np.ndarray, vol2: np.ndarray, vol1ismsk: bool = False,
                   vol2ismsk: bool = False, usemeanips: bool = False):
    """Per-slice (or mean-IP) anterior/inferior px distances between two
    aligned volumes (ref: calc_distances, evaluate_cv.py:142-169)."""
    assert vol1.shape == vol2.shape, \
        f"wrong shape? vol1: {vol1.shape} vol2: {vol2.shape}"
    ants1, infs1 = _extract_ips(vol1, vol1ismsk)
    ants2, infs2 = _extract_ips(vol2, vol2ismsk)
    if usemeanips:
        ants1, infs1 = _mean_ips(ants1, infs1)
        ants2, infs2 = _mean_ips(ants2, infs2)
    ant, inf = get_distances((ants1, infs1), (ants2, infs2))
    return np.array(ant, dtype=float), np.array(inf, dtype=float)


def calc_dist_files(gt_f: str, pred_f: str, gtismsk: bool = False,
                    predismsk: bool = False, physical: bool = False,
                    usemeanips: bool = False) -> List[float]:
    """[ant_mean, ant_sd, inf_mean, inf_sd] distances between two files, in
    px or mm (ref: calc_dist_files, evaluate_cv.py:171-182)."""
    gt_img = read_image(gt_f)
    pred = read_image(pred_f).array
    ant, inf = calc_distances(gt_img.array, pred, vol1ismsk=gtismsk,
                              vol2ismsk=predismsk, usemeanips=usemeanips)
    if physical:
        ant = ant * gt_img.inplane_spacing
        inf = inf * gt_img.inplane_spacing
    return [float(np.nanmean(ant)), float(np.nanstd(ant)),
            float(np.nanmean(inf)), float(np.nanstd(inf))]


def calc_angles2x(vol: np.ndarray, ismsk: bool = False,
                  usemeanips: bool = False) -> np.ndarray:
    """Per-slice (or mean-IP) septum angles of one volume
    (ref: calc_angles2x, evaluate_cv.py:185-198)."""
    ants, infs = _extract_ips(vol, ismsk)
    if usemeanips:
        ants, infs = _mean_ips(ants, infs)
    return get_angles2x((ants, infs))


def calc_mean_angle(file_: str, ismsk: bool = False,
                    usemeanips: bool = False) -> List[float]:
    """[mean, sd] septum angle of one mask file (ref: :201-207)."""
    angles = np.array(calc_angles2x(read_image(file_).array, ismsk=ismsk,
                                    usemeanips=usemeanips), dtype=float)
    return [float(np.nanmean(angles)), float(np.nanstd(angles))]


def calc_mean_angle_diff(gt_f: str, pred_f: str, isgtmsk: bool = False,
                         ispredmsk: bool = False, usemeanips: bool = False):
    """(|gt-pred| mean-angle difference, gt mean, gt sd, pred mean, pred sd)
    (ref: calc_mean_angle_diff, evaluate_cv.py:210-219)."""
    gt_mean, gt_sd = calc_mean_angle(gt_f, ismsk=isgtmsk,
                                     usemeanips=usemeanips)
    pred_mean, pred_sd = calc_mean_angle(pred_f, ismsk=ispredmsk,
                                         usemeanips=usemeanips)
    return abs(gt_mean - pred_mean), gt_mean, gt_sd, pred_mean, pred_sd


def angle_columns(suffix: str) -> List[str]:
    return [f"angle_diff_{suffix}", "gt_angle", "gt_angle_sd",
            f"{suffix}_angle", f"{suffix}_angle_sd"]


def dist_columns(suffix: str) -> List[str]:
    return [f"ant_dist_{suffix}", f"ant_dist_sd_{suffix}",
            f"inf_dist_{suffix}", f"inf_dis_sd_{suffix}"]


def get_angles_as_df(files1: Sequence[str], files2: Sequence[str],
                     f1ismsk: bool = False, f2ismsk: bool = False,
                     suffix: str = "pred", meanips: bool = False
                     ) -> List[Dict]:
    """Angle stats per file pair as rows (ref: get_angles_as_df, :229-239)."""
    return [dict(zip(angle_columns(suffix), calc_mean_angle_diff(
        f1, f2, isgtmsk=f1ismsk, ispredmsk=f2ismsk, usemeanips=meanips)))
        for f1, f2 in zip(files1, files2)]


def get_dist_as_df(files1: Sequence[str], files2: Sequence[str],
                   f1ismsk: bool = False, f2ismsk: bool = False,
                   suffix: str = "pred", meanips: bool = False
                   ) -> List[Dict]:
    """Distance stats per file pair as rows (ref: get_dist_as_df, :242-254)."""
    return [dict(zip(dist_columns(suffix), calc_dist_files(
        f1, f2, gtismsk=f1ismsk, predismsk=f2ismsk, physical=False,
        usemeanips=meanips)))
        for f1, f2 in zip(files1, files2)]
