"""Volume and phase analytics over CMR files — counterpart of
``cmrtpu/data/analytics.py`` (ref: src/data/Dataset.py describe_volume
:1223-1463, calc_vol_along_t :1466-1487, create_lv_vol_df :1489-1531,
predict_phase_from_vol :1532-1556), without pandas.

Cohort statistics for the dataset notebooks, and the ED/ES phase of a cine
predicted from its LV volume curve. Tables that cmrtpu returns as
DataFrames are lists of row dicts here, with the same columns in the same
order (a key a row lacks is NaN, as in the DataFrame); csv files are read
with the ``csv`` module and each column typed as pandas' ``read_csv``
types it (int, else float, else str; an empty cell is NaN).
"""

from __future__ import annotations

import csv
import glob
import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from cmrtpu_torch.io import MedicalImage, read_image

_PHASE_COLS = ["ED#", "MS#", "ES#", "PF#", "MD#"]


def describe_volume(f_name: Union[str, MedicalImage],
                    image: bool = True) -> Dict[str, object]:
    """Flat dict of geometry and intensity statistics of a 2D/3D/4D file
    (ref: describe_volume, src/data/Dataset.py:1223-1345): x/y/z/t-axis,
    x/y/z/t-spacing, slices, min/max/mean, .99/.75/.50 quantiles, sizes,
    dimension, and the DICOM tags the image's metadata holds."""
    img = f_name if isinstance(f_name, MedicalImage) else read_image(str(f_name))
    nda = img.array
    spacing = img.spacing  # x fastest, sitk order
    rep: Dict[str, object] = {
        "f_name": f_name if isinstance(f_name, str) else "<in-memory>",
        "image": image,
        "shape": nda.shape,
        "spacing": tuple(spacing),
    }
    if nda.ndim == 4:  # t, z, y, x
        rep.update({"x-axis": nda.shape[3], "y-axis": nda.shape[2],
                    "z-axis": nda.shape[1], "t-axis": nda.shape[0],
                    "slices": nda.shape[1] * nda.shape[0],
                    "x-spacing": spacing[0], "y-spacing": spacing[1],
                    "z-spacing": spacing[2], "t-spacing": spacing[3]})
    elif nda.ndim == 3:  # z, y, x
        rep.update({"x-axis": nda.shape[2], "y-axis": nda.shape[1],
                    "z-axis": nda.shape[0], "t-axis": 0,
                    "slices": nda.shape[0],
                    "x-spacing": spacing[0], "y-spacing": spacing[1],
                    "z-spacing": spacing[2], "t-spacing": 0})
    else:  # 2D
        rep.update({"x-axis": nda.shape[1], "y-axis": nda.shape[0],
                    "z-axis": 0, "t-axis": 0, "slices": 1,
                    "x-spacing": spacing[0], "y-spacing": spacing[1],
                    "z-spacing": 0, "t-spacing": 0})
    flat = nda.reshape(-1)
    rep["min"] = float(flat.min())
    rep["max"] = float(flat.max())
    rep["mean"] = float(flat.mean())
    rep[".99-quantile"] = float(np.quantile(flat, 0.99))
    rep[".75-quantile"] = float(np.quantile(flat, 0.75))
    rep[".50-quantle"] = float(np.quantile(flat, 0.50))  # [sic] ref key name
    rep["sizes"] = str(img.size)
    rep["dimension"] = int(nda.ndim)
    for key in ("0028|0010", "0028|0011", "0020|000e", "0008|103e",
                "0018|1090", "0018|0087", "0018|0050", "0018|5100",
                "0020|1041"):
        if key in img.metadata:
            rep[key] = img.metadata[key]
    return rep


def calc_vol_along_t(file_4d: Union[str, MedicalImage], label: int = 3
                     ) -> np.ndarray:
    """Per-time-step volume (ml) of one label of a 4D CMR
    (ref: calc_vol_along_t, Dataset.py:1466-1487). Labels 0, 1, 2, 3 =
    background, RV, MYO, LV."""
    img = file_4d if isinstance(file_4d, MedicalImage) \
        else read_image(str(file_4d))
    assert img.ndim == 4, f"please provide 4D files, got: {img.ndim}"
    voxels = (img.array == label).sum(axis=(1, 2, 3))
    voxel_size = img.spacing[0] * img.spacing[1] * img.spacing[2]
    return (voxels * voxel_size) / 1000.0


def create_lv_vol_df(filenames: Sequence[str], dataset: str = "acdc"
                     ) -> List[Dict]:
    """LV-volume curve rows, one per 4D file, with the argmax (ED) and
    argmin (ES) time steps (ref: create_lv_vol_df, Dataset.py:1489-1531)."""
    assert len(filenames) > 0, "please provide a list of 4D files"
    assert dataset in ("acdc", "tof")
    rows = []
    for f in filenames:
        volumes = calc_vol_along_t(f)
        patient_long = os.path.basename(f).split("_")[0]
        patient = patient_long.split("patient")[1] if dataset == "acdc" \
            else patient_long.split("-")[1].lower()
        rows.append({"patient_long": patient_long, "patient": patient,
                     "ed_idxs": int(np.argmax(volumes)),
                     "es_idxs": int(np.argmin(volumes)),
                     "volume_change": volumes, "cycle_len": len(volumes)})
    return rows


def _inner_merge(left: List[Dict], right: List[Dict], on: str) -> List[Dict]:
    """pandas' ``left.merge(right, on=on, how="inner")``: the left rows in
    their order, each with every right row of its key in theirs; a column
    both sides hold besides ``on`` is suffixed _x (left) and _y (right)."""
    if not left or not right:
        return []
    shared = (set(left[0]) & set(right[0])) - {on}
    out = []
    for lrow in left:
        for rrow in right:
            if rrow[on] != lrow[on]:
                continue
            row = {(k + "_x" if k in shared else k): v
                   for k, v in lrow.items()}
            row.update({(k + "_y" if k in shared else k): v
                        for k, v in rrow.items() if k != on})
            out.append(row)
    return out


def predict_phase_from_vol(filenames: Sequence[str],
                           gt_df: Optional[List[Dict]] = None,
                           dataset: str = "acdc") -> List[Dict]:
    """ED/ES time steps predicted from the LV volume curve and, with
    ground-truth phase rows (patient, ED#, ES#), the cyclic frame distance
    (pfd) and accuracy of each (ref: predict_phase_from_vol,
    Dataset.py:1532-1556)."""
    rows = create_lv_vol_df(filenames, dataset=dataset)
    if gt_df is None:
        return rows
    gt = [dict(r, patient=str(r["patient"]).zfill(3)) for r in gt_df]
    merged = _inner_merge(rows, gt, "patient")
    for phase, pred_col, gt_col in (("ed", "ed_idxs", "ED#"),
                                    ("es", "es_idxs", "ES#")):
        if not merged or gt_col not in merged[0]:
            continue
        for row in merged:
            # cyclic frame distance within the patient's cycle length
            diff = abs(row[pred_col] - row[gt_col])
            row[f"pfd_{phase}"] = min(diff, row["cycle_len"] - diff)
            row[f"acc_{phase}"] = float(row[f"pfd_{phase}"] == 0)
    for phase in ("ed", "es"):
        if merged and f"pfd_{phase}" in merged[0]:
            logging.info("%s: mean pFD %.2f, accuracy %.2f", phase.upper(),
                         np.mean([r[f"pfd_{phase}"] for r in merged]),
                         np.mean([r[f"acc_{phase}"] for r in merged]))
    return merged


def _first_arg(rows: Sequence[Dict], col: str, pick) -> int:
    """Index of the first row holding ``pick`` (min or max) of ``col``,
    NaN skipped, as pandas' idxmin / idxmax."""
    values = [(r[col], i) for i, r in enumerate(rows)
              if not (isinstance(r[col], float) and math.isnan(r[col]))]
    best = pick(v for v, _ in values)
    return next(i for v, i in values if v == best)


def get_min_max_t_per_patient(df_patient: Sequence[Dict],
                              col: str = "vol in ml",
                              target_col: str = "t_norm") -> dict:
    """The time steps of one patient's min and max of ``col``
    (ref: get_min_max_t_per_patient, src/data/Dataset.py:1410-1428)."""
    patients = list(dict.fromkeys(r["patient"] for r in df_patient))
    assert len(patients) == 1, "more than one patient in df"
    return {"patient": patients[0],
            "min_t": df_patient[_first_arg(df_patient, col, min)][target_col],
            "max_t": df_patient[_first_arg(df_patient, col, max)][target_col]}


def get_extremas(df: Sequence[Dict], col: str = "vol in ml",
                 target_col: str = "t_norm") -> List[Dict]:
    """Per-patient min/max time-step rows (an ED/ES proxy from volume
    curves, ref: get_extremas, src/data/Dataset.py:1430-1433)."""
    return [get_min_max_t_per_patient([r for r in df if r["patient"] == p],
                                      col, target_col)
            for p in dict.fromkeys(r["patient"] for r in df)]


def _table(rows: Sequence[Dict]) -> List[Dict]:
    """Rows with the union of their keys in order of first appearance, a
    missing one NaN — what ``pd.DataFrame(rows).to_dict("records")``
    gives."""
    keys = list(dict.fromkeys(k for r in rows for k in r))
    return [{k: r.get(k, math.nan) for k in keys} for r in rows]


def describe_path(path: str = "data/processed/train/",
                  dataset: str = "ACDC",
                  wildcard: Optional[str] = None) -> List[Dict]:
    """``describe_volume`` rows of every image (and mask) under ``path``
    (ref: describe_path, src/data/Dataset.py:1352-1407). ``wildcard``
    replaces the dataset's glob; 'ACDC' globs the frameXX.nii.gz pairs
    recursively, any other dataset the clean/img/msk naming fallbacks."""
    files: Dict[str, List[str]] = {}
    if wildcard:
        logging.info("Using wildcard description: %s", wildcard)
        files["images"] = sorted(glob.glob(os.path.join(path, wildcard)))
    elif dataset == "ACDC":
        files["images"] = sorted(glob.glob(
            os.path.join(path, "**/*frame[0-9][0-9].nii.gz"), recursive=True))
        files["masks"] = sorted(glob.glob(
            os.path.join(path, "**/*frame*_gt.nii.gz"), recursive=True))
    else:  # GCN naming fallbacks (ref: Dataset.py:1370-1386)
        for img_pat, msk_pat in (("*clean.nrrd", "*mask.nrrd"),
                                 ("*img.nrrd", "*msk.nrrd"),
                                 ("**/*img.nrrd", "**/*msk.nrrd"),
                                 ("**/images/*.nrrd", "**/masks/*.nrrd")):
            files["images"] = sorted(glob.glob(os.path.join(path, img_pat)))
            files["masks"] = sorted(glob.glob(os.path.join(path, msk_pat)))
            if files["images"]:
                break
    logging.info("describing path: %s", path)
    assert files.get("images"), "No files found!"
    rows = [describe_volume(f) for f in files["images"]]
    rows += [describe_volume(f, image=False) for f in files.get("masks", [])]
    return _table(rows)


def _typed(values: List[str]) -> List:
    """A csv column typed as ``pd.read_csv`` types it: int when every cell
    is one, else float when every cell is a number or empty (NaN), else
    str with empty cells NaN."""
    def parses(cast, v):
        try:
            cast(v)
            return True
        except ValueError:
            return False

    if values and all(parses(int, v) for v in values):
        return [int(v) for v in values]
    if all(v == "" or parses(float, v) for v in values):
        return [math.nan if v == "" else float(v) for v in values]
    return [math.nan if v == "" else v for v in values]


def _read_csv(filename: str) -> List[Dict]:
    with open(filename, newline="", encoding="utf-8") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        cells = list(reader)
    columns = [_typed([r[i] for r in cells]) for i in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)]


def load_tof_phase_gt(filename: str) -> List[Dict]:
    """Cardiac-phase ground truth of the TOF cohort: 1-based phase indices
    shifted to 0-based, patient ids lower-cased, the first row of each
    patient kept (ref: load_tof_phase_gt, src/data/Dataset.py:1435-1456)."""
    rows, seen = [], set()
    for r in _read_csv(filename):
        patient = r["patient"].lower()
        if patient in seen:
            continue
        seen.add(patient)
        rows.append({"patient": patient,
                     **{c: int(r[c] - 1) for c in _PHASE_COLS}})
    return rows


def load_acdc_phase_gt(filename: str) -> List[Dict]:
    """Cardiac-phase ground truth of ACDC: patient ids zero-padded to 3
    digits, indices as stored (ref: load_acdc_phase_gt,
    src/data/Dataset.py:1458-1463)."""
    return [dict(r, patient=str(r["patient"]).zfill(3))
            for r in _read_csv(filename)]
