"""CV evaluation: assemble the per-patient df_eval.csv without pandas —
counterpart of ``cmrtpu/eval/evaluate.py``: ``evaluate_cv`` and the lighter
``evaluate_cv_save``.

Per patient x phase: insertion points from the prediction / GT /
inter-observer / original ventricle masks, mean-IP and slice-wise angles and
mm distances (plain, single-also, upper-bound variants) and slice-, point-
and threshold-based TPR/PPV (ref: src/models/evaluate_cv.py:662-883), and
for a HEADS experiment one hard-dice column per label of each extra head
family written next to the ``*_msk.nrrd`` predictions. The
columns are computed by the same functions in the same order as cmrtpu's
DataFrame, and each cell is written as pandas' ``to_csv`` writes it, so on
the same tree the two df_eval.csv files are equal byte for byte:

  * a column of ints only is an int column: ``str``;
  * a column of numbers and missing values is a float column: ``repr`` of
    the float, an empty cell where missing;
  * any other column is an object column: ``str`` of the value (tuples and
    numpy arrays included), an empty cell for None or NaN.
"""

from __future__ import annotations

import csv
import glob
import logging
import math
import numbers
import os
from typing import Dict, List, Optional

import numpy as np

from cmrtpu_torch.data.dataset import get_acdc_pathologies
from cmrtpu_torch.eval import landmarks as LM
from cmrtpu_torch.eval.file_metrics import (angle_columns, dist_columns,
                                            get_angles_as_df, get_dist_as_df)
from cmrtpu_torch.io import read_image
from cmrtpu_torch.train.losses import dice_numpy


def _align_by_patient_phase(files, patients, phases):
    """Order frame-named source files (``patientXXX_frameYY_*``) onto the
    pred rows' (patient, ED|ES) keys. Per patient, the lowest frame number is
    ED and the next ES (ACDC convention, ref: predict_model.py:109-116).
    Rows with no matching file get None."""
    by_patient = {}
    for f in files:
        base = os.path.basename(f)
        patient = base.split("_")[0]
        frame = int(base.split("_")[1].split("frame")[1].split(".")[0])
        by_patient.setdefault(patient, []).append((frame, f))
    lookup = {}
    for patient, frame_files in by_patient.items():
        # only the two lowest frames map to phases; extra annotated frames
        # (e.g. 4D exports) must not steal the ES slot
        for rank, (_, f) in enumerate(sorted(frame_files)[:2]):
            lookup[(patient, "ED" if rank == 0 else "ES")] = f
    return [lookup.get(key) for key in zip(patients, phases)]


def _head_suffixes(pred_files):
    """Extra multi-head output families next to the *_msk.nrrd predictions:
    every sibling ``<patient>_<phase>_<suffix>.nrrd`` whose suffix is not
    ``msk`` or ``cmr``."""
    suffixes = set()
    for f in pred_files:
        base = os.path.basename(f)
        if not base.endswith("_msk.nrrd"):
            continue
        stem = base[: -len("_msk.nrrd")]
        for g in glob.glob(os.path.join(os.path.dirname(f), stem + "_*.nrrd")):
            suffix = os.path.basename(g)[len(stem) + 1: -len(".nrrd")]
            if suffix not in ("msk", "cmr"):
                suffixes.add(suffix)
    return sorted(suffixes)


def _sibling_file(path: str, suffix: str):
    cand = path.replace("_msk.nrrd", f"_{suffix}.nrrd")
    return cand if cand != path and os.path.isfile(cand) else None


# ACDC ventricle labels 1/2/3 = RV cavity / myocardium / LV cavity
_ACDC_STRUCTURES = {1: "rv", 2: "myo", 3: "lv"}


def _append_seg_dice_columns(col: Dict[str, List], suffix: str) -> None:
    """Per-structure hard dice between a head's pred and gt label masks,
    one column per foreground label: rv/myo/lv when the gt labels are
    exactly {1, 2, 3}, l<k> otherwise. Missing files give an empty cell;
    when the whole gt family is missing the columns follow the labels
    predicted. A label absent from both masks of a pair scores 1.0
    (``dice_numpy``'s empty score). One pair is read at a time."""
    pred_col = [_sibling_file(f, suffix) for f in col["files_pred"]]
    gt_col = [_sibling_file(f, suffix) for f in col["files_gt"]]
    col[f"files_{suffix}_pred"] = pred_col
    col[f"files_{suffix}_gt"] = gt_col

    row_dices = []
    gt_labels = set()
    for pf, gf in zip(pred_col, gt_col):
        if not (pf and gf):
            row_dices.append(None)
            continue
        pred = read_image(pf).array
        gt = read_image(gf).array
        present = (set(np.unique(gt).astype(int))
                   | set(np.unique(pred).astype(int))) - {0}
        row_dices.append({l: dice_numpy(gt == l, pred == l)
                          for l in present})
        gt_labels |= set(np.unique(gt).astype(int)) - {0}
    labels = gt_labels
    if not labels:  # gt family absent: keep the schema from the predictions
        labels = {l for d in row_dices if d for l in d}
    labels = sorted(labels)
    names = {l: _ACDC_STRUCTURES[l] for l in labels} \
        if set(labels) == set(_ACDC_STRUCTURES) \
        else {l: f"l{l}" for l in labels}
    for label in labels:
        col[f"{suffix}_dice_{names[label]}"] = [
            np.nan if d is None else d.get(label, 1.0) for d in row_dices]


# filename sorting rules (ref: evaluate_cv.py:222-225)
def sorting_lambda(x):
    return int(os.path.basename(x).split("_")[0].split("patient")[1])


def sorting_lambda_frame(x):
    return (int(os.path.basename(x).split("_")[0].split("patient")[1]),
            int(os.path.basename(x).split("_")[1].split("frame")[1]))


def _experiment_files(exp_path: str):
    """(pred, gt, cmr) files of every fold, each sorted by patient: under
    ``<exp>/*/*/`` (a timestamped run's folds), else, with no prediction
    there, under the flat ``<exp>/*/``."""
    for root in (os.path.join(exp_path, "*/*/"),
                 os.path.join(exp_path, "*/")):
        pred = sorted(glob.glob(os.path.join(root, "pred", "*msk.nrrd")),
                      key=sorting_lambda)
        if pred:
            break
    return pred, *(sorted(glob.glob(os.path.join(root, sub, pattern)),
                          key=sorting_lambda)
                   for sub, pattern in (("gt", "*msk.nrrd"),
                                        ("pred", "*cmr.nrrd")))


def _data_files(data_path: str):
    """(inter-observer RVIP files, original ventricle masks), each sorted
    by patient and frame."""
    return tuple(sorted(glob.glob(os.path.join(data_path, *parts)),
                        key=sorting_lambda_frame)
                 for parts in (("io", "*rvip.nrrd"),
                               ("original", "*/*frame*gt.nii.gz")))


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, numbers.Number) and not isinstance(v, bool)


def _cells(values: List) -> List[str]:
    """One column's cells as pandas' ``to_csv`` writes the column it
    infers from these values (see the module docstring)."""
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
           for v in values):
        return [str(int(v)) for v in values]
    if all(_missing(v) or _is_number(v) for v in values):
        return ["" if _missing(v) else repr(float(v)) for v in values]
    return ["" if _missing(v) else str(v) for v in values]


def write_csv(columns: Dict[str, List], path: str) -> None:
    """Write columns (name -> values, in order) as ``to_csv(index=False)``."""
    cells = [_cells(values) for values in columns.values()]
    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(list(columns))
        writer.writerows(zip(*cells))


def _scaled(values, spacing):
    return [None if v is None else v * s for v, s in zip(values, spacing)]


def evaluate_cv(exp_path: str, data_path: str,
                out_csv: Optional[str] = None) -> Dict[str, List]:
    """Evaluate every fold's predictions under ``exp_path`` against the
    sources under ``data_path``; write ``df_eval.csv`` (or ``out_csv``) and
    return its columns, name -> one value per patient-phase row."""
    data_root = data_path
    path_to_exp = exp_path
    glob_exp = os.path.join(path_to_exp, "*/*/")

    pred_files, gt_files, cmr_files = _experiment_files(path_to_exp)
    io_files, orig_msk_files = _data_files(data_root)
    logging.info("source files: %d pred / %d gt / %d cmr / %d inter-observer",
                 len(pred_files), len(gt_files), len(cmr_files), len(io_files))
    logging.info("original ventricle-mask files: %d", len(orig_msk_files))

    if not pred_files:
        raise FileNotFoundError(
            f"no prediction masks under {glob_exp}pred/ or "
            f"{path_to_exp}/*/pred/ — run predict first (pred_fold) or check "
            "the -exp path (expects the timestamped experiment root)")
    if len(gt_files) != len(pred_files):
        raise ValueError(f"{len(pred_files)} prediction masks but "
                         f"{len(gt_files)} gt masks under {path_to_exp}")

    col: Dict[str, List] = {}
    col["files_pred"] = list(pred_files)
    col["files_gt"] = list(gt_files)
    rows = range(len(pred_files))
    col["patient"] = [os.path.basename(x).split("_")[0] for x in pred_files]
    col["phase"] = [os.path.basename(x).split("_")[1] for x in pred_files]

    # io / original-mask sources are joined by patient + phase; a missing
    # file leaves that row's io/orig cells empty
    have_io = len(io_files) > 0
    have_orig = len(orig_msk_files) > 0
    if have_io:
        col["files_io"] = _align_by_patient_phase(
            io_files, col["patient"], col["phase"])
    if have_orig:
        col["files_orig_msk"] = _align_by_patient_phase(
            orig_msk_files, col["patient"], col["phase"])
    try:
        pathology = get_acdc_pathologies(os.path.join(data_root, "original"))
        col["pathology"] = [pathology.get(p) for p in col["patient"]]
    except (IndexError, OSError, ValueError) as exc:
        # a tree without a file of cmrtpu's table: the column stays empty
        logging.warning(
            "pathology join against %s/original failed (%s: %s) — the "
            "'pathology' column will be empty", data_root,
            type(exc).__name__, exc)
        col["pathology"] = [None for _ in rows]

    col["spacing"] = [read_image(x).spacing for x in col["files_gt"]]
    spacing = col["inplane_spacing"] = [x[0] for x in col["spacing"]]

    # --- insertion points per source -----------------------------------
    col["ips_pred"] = [LM.get_ip_from_rvip_file(x, keepdim=True)
                       for x in col["files_pred"]]
    col["ips_gt"] = [LM.get_ip_from_rvip_file(x, keepdim=True)
                     for x in col["files_gt"]]
    ips_gt = col["ips_gt"]
    if have_io:
        col["ips_io"] = [LM.get_ip_from_rvip_file(x, keepdim=True)
                         if isinstance(x, str) else None
                         for x in col["files_io"]]
    if have_orig:
        col["ips_orig_msk"] = [LM.get_ip_from_ventriclemsk_file(x, keepdim=True)
                               if isinstance(x, str) else None
                               for x in col["files_orig_msk"]]

    # --- mean ips, mean angles, mean-angle diffs, mean distances -------
    sources = ["pred"] + (["io"] if have_io else []) \
        + (["orig_msk"] if have_orig else [])
    mips_gt = col["mips_gt"] = [LM.calc_mean_ip(x) for x in ips_gt]
    mangle_gt = col["mangle_gt"] = [LM.get_angle2x(x[0], x[1])
                                    for x in mips_gt]
    suffix_map = {"pred": "gtpred", "io": "gtio", "orig_msk": "gtorig"}
    for src in sources:
        mips = col[f"mips_{src}"] = [
            LM.calc_mean_ip(x) if x is not None else (np.nan, np.nan)
            for x in col[f"ips_{src}"]]
        mangle = col[f"mangle_{src}"] = [LM.get_angle2x(x[0], x[1])
                                         for x in mips]
        suf = suffix_map[src]
        col[f"mdiffs_{suf}"] = [LM.get_diff(a, b)
                                for a, b in zip(mangle_gt, mangle)]
        for k, side in ((0, "ant"), (1, "inf")):
            col[f"mdists_{side}_{suf}"] = _scaled(
                [LM.get_dist(g[k], m[k]) for g, m in zip(mips_gt, mips)],
                spacing)

    # --- slice-wise angles, distances, angle diffs ---------------------
    angles_gt = col["angles_gt"] = [LM.get_angles2x(x) for x in ips_gt]
    for src in sources:
        suf = suffix_map[src]
        ips = col[f"ips_{src}"]
        angles = col[f"angles_{src}"] = [
            LM.get_angles2x(x) if x is not None
            else np.array([None] * len(g[0])) for x, g in zip(ips, ips_gt)]
        dists = [LM.get_distances(g, x, s) if x is not None
                 else (np.array([None] * len(g[0])),
                       np.array([None] * len(g[1])))
                 for g, x, s in zip(ips_gt, ips, spacing)]
        col[f"dists_ant_{suf}"] = [d[0] for d in dists]
        col[f"dists_inf_{suf}"] = [d[1] for d in dists]
        col[f"diffs_{suf}"] = [LM.get_differences(a, b)
                               for a, b in zip(angles_gt, angles)]
    col["EXP"] = [path_to_exp for _ in rows]

    def rates(fn, ips, thresh=None):
        """(anterior, inferior) of ``fn`` (TPR or PPV) per row; with
        ``thresh`` in mm at the row's in-plane spacing."""
        out = []
        for g, x, s in zip(ips_gt, ips, spacing):
            if x is None:
                out.append((np.nan, np.nan))
            elif thresh is None:
                out.append(fn(g, x))
            else:
                out.append(fn(g, x, thresh=thresh, spacing=s))
        return out

    # --- TPR / PPV: slice-based ----------------------------------------
    tpr_suffix = {"pred": "", "io": "_io", "orig_msk": "_msk"}
    for src in sources:
        s = tpr_suffix[src]
        for name, fn in (("tpr", LM.calc_tpr_thresh),
                         ("ppv", LM.calc_ppv_thresh)):
            ant_inf = rates(fn, col[f"ips_{src}"])
            col[f"{name}_ant{s}"] = [v[0] for v in ant_inf]
            col[f"{name}_inf{s}"] = [v[1] for v in ant_inf]

    # --- point-based (single-IP-also), plain and with a 15 mm threshold -
    single = col["ips_pred_single_also"] = [
        LM.get_ip_from_rvip_file(x, keepdim=True, both_only=False)
        for x in col["files_pred"]]
    for tail, thresh in (("point", None), ("point_th15", 15)):
        for name, fn in (("tpr", LM.calc_tpr_thresh),
                         ("ppv", LM.calc_ppv_thresh)):
            ant_inf = rates(fn, single, thresh)
            col[f"{name}_ant_{tail}"] = [v[0] for v in ant_inf]
            col[f"{name}_inf_{tail}"] = [v[1] for v in ant_inf]

    # --- single-also mean distances ------------------------------------
    mips_single = col["mips_pred_single_also"] = [LM.calc_mean_ip(x)
                                                  for x in single]
    for k, side in ((0, "ant"), (1, "inf")):
        col[f"mdists_{side}_gtpred_single_also"] = _scaled(
            [LM.get_dist(g[k], m[k]) for g, m in zip(mips_gt, mips_single)],
            spacing)

    # --- slice-wise mean distances (both-only / single-also, plain / UB) -
    for side in ("ant", "inf"):
        col[f"mdists_{side}_gtpred_slice_wise"] = [
            LM.get_mean_dist(d) for d in col[f"dists_{side}_gtpred"]]
    for tail, fn, ips in (
            ("single_also", LM.get_distances, single),
            ("up", LM.get_distances_upper_bound, col["ips_pred"]),
            ("single_also_up", LM.get_distances_upper_bound, single)):
        dists = [fn(g, x, s) for g, x, s in zip(ips_gt, ips, spacing)]
        col[f"dists_ant_gtpred_{tail}"] = [d[0] for d in dists]
        col[f"dists_inf_gtpred_{tail}"] = [d[1] for d in dists]
        for side in ("ant", "inf"):
            col[f"mdists_{side}_gtpred_slice_wise_{tail}"] = [
                LM.get_mean_dist(d) for d in col[f"dists_{side}_gtpred_{tail}"]]

    # --- multi-head families: per-structure dice ------------------------
    for suffix in _head_suffixes(pred_files):
        _append_seg_dice_columns(col, suffix)

    out_csv = out_csv or os.path.join(path_to_exp, "df_eval.csv")
    write_csv(col, out_csv)
    logging.info("evaluation written for %s -> %s", glob_exp, out_csv)
    return col


def evaluate_cv_save(exp_path: str, data_path: str) -> List[Dict]:
    """The lighter evaluation (ref: evaluate_cv_save,
    src/models/evaluate_cv.py:599-660): mean-IP angle and distance stats
    (``get_angles_as_df``, ``get_dist_as_df``) of the prediction,
    inter-observer and original ventricle-mask sources against the gt
    files, paired by position, with pred_files, patient, phase and
    pathology; written as ``<exp_path>/df_eval.csv``, the bytes cmrtpu's
    ``evaluate_cv_save`` writes. Returns the rows.

    A source whose file count is not the gt files' is skipped with a
    warning (it would mis-pair); when every source is skipped this raises.
    A failed pathology join leaves the column empty. A column name met
    again (``gt_angle`` of each source) keeps its first values and place,
    as cmrtpu's ``df.columns.duplicated()`` drop does."""
    glob_exp = os.path.join(exp_path, "*/*/")
    pred_files, gt_files, _ = _experiment_files(exp_path)
    io_files, orig_msk_files = _data_files(data_path)
    if not pred_files:
        raise FileNotFoundError(f"no prediction masks under {glob_exp}pred/")

    sources = []
    for files, ismsk, sfx in ((pred_files, False, "pred"),
                              (io_files, False, "io"),
                              (orig_msk_files, True, "orig_msk")):
        if len(files) == len(gt_files):
            sources.append((files, ismsk, sfx))
        else:
            logging.warning("skip source '%s': %d files != %d gt files "
                            "(would mis-pair positionally)",
                            sfx, len(files), len(gt_files))
    if not sources:
        raise FileNotFoundError(
            f"every source was skipped: pred/gt file counts differ "
            f"({len(pred_files)} pred vs {len(gt_files)} gt under {glob_exp}) "
            "— check the experiment layout, or use evaluate_cv (which joins "
            "by patient+phase instead of positionally)")
    if len(gt_files) != len(pred_files):
        raise ValueError(f"{len(pred_files)} prediction masks for "
                         f"{len(gt_files)} rows")

    col: Dict[str, List] = {}
    for table, names in ((get_angles_as_df, angle_columns),
                         (get_dist_as_df, dist_columns)):
        for files, ismsk, sfx in sources:
            rows = table(gt_files, files, f2ismsk=ismsk, suffix=sfx,
                         meanips=True)
            for name in names(sfx):
                col.setdefault(name, [r[name] for r in rows])
    col.setdefault("pred_files", list(pred_files))
    col.setdefault("patient", [os.path.basename(x).split("_")[0]
                               for x in pred_files])
    col.setdefault("phase", [os.path.basename(x).split("_")[1]
                             for x in pred_files])
    try:
        pathology = get_acdc_pathologies(os.path.join(data_path, "original"))
        col.setdefault("pathology", [pathology.get(p)
                                     for p in col["patient"]])
    except (IndexError, OSError, ValueError) as exc:
        logging.warning(
            "pathology join against %s/original failed (%s: %s) — the "
            "'pathology' column will be empty", data_path,
            type(exc).__name__, exc)
        col.setdefault("pathology", [None] * len(pred_files))
    write_csv(col, os.path.join(exp_path, "df_eval.csv"))
    logging.info("evaluation written for %s", glob_exp)
    return [dict(zip(col, values)) for values in zip(*col.values())]
