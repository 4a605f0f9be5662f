"""File naming, volume slicing, ACDC metadata and fold tables — the
counterpart of ``cmrtpu/data/dataset.py`` without pandas or scikit-learn
(the card has neither).

Conventions kept bit-exact with the reference so its df_kfold.csv files
keep working: 2D slice names '<patient>__t<frame>_z<z>_img|msk.nrrd', fold
table columns [x_path, y_path, fold, modality, patient, pathology], and the
patient-id rules (ref: src/data/Dataset.py:552-559, :609-623, :625-678).
Tables that cmrtpu returns as DataFrames are lists of row dicts here, with
the same columns in the same order. ``write_kfold_csv`` of
``get_kfolded_data`` and ``write_acdc_cv_csv`` of
``create_acdc_dataframe_for_cv`` write the same bytes as cmrtpu's
``to_csv(index=False)`` of its DataFrames.
"""

from __future__ import annotations

import csv
import glob
import logging
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.io.geometry import copy_meta
from cmrtpu_torch.utils.io_utils import ensure_dir

KFOLD_COLUMNS = ("x_path", "y_path", "fold", "modality", "patient",
                 "pathology")
# cmrtpu concatenates the stratified folds with ``sort=True``, which sorts
# the columns
ACDC_CV_COLUMNS = tuple(sorted(KFOLD_COLUMNS))


def get_patient(filename: str) -> str:
    """Patient id from a 2D nrrd filename (ref: Dataset.py:609-623)."""
    base = os.path.basename(filename)
    if re.search("__", filename):
        return base.split("__")[0]
    if base.startswith("patient"):  # acdc file
        return base.split("_")[0]
    return "_".join(base.split("_")[:2])  # gcn filename


def slice_file_name(patient: str, frame: str, z: int, kind: str) -> str:
    return f"{patient}__t{frame}_z{z}_{kind}.nrrd"


def create_2d_slices_from_3d_volume_files(img_f: str, mask_f: Optional[str],
                                          export_path: str) -> List[str]:
    """Slice a 3D img/mask pair into per-z 2D nrrd files
    (ref: Dataset.py:519-562). Returns the written image paths."""
    logging.info("process file: %s", img_f)
    if not mask_f:
        mask_f = img_f
    img_3d = read_image(img_f)
    mask_3d = read_image(mask_f)

    patient = os.path.basename(img_f).split("_")[0]
    frame = os.path.basename(img_f).split("frame")[1][:2]
    ensure_dir(export_path)
    written = []
    for z in range(img_3d.array.shape[0]):
        img2d = copy_meta(MedicalImage(array=img_3d.array[z]), img_3d)
        msk2d = copy_meta(MedicalImage(array=mask_3d.array[z]), img_3d)
        img_path = os.path.join(export_path,
                                slice_file_name(patient, frame, z, "img"))
        write_image(img2d, img_path)
        write_image(msk2d, os.path.join(
            export_path, slice_file_name(patient, frame, z, "msk")))
        written.append(img_path)
    return written


def create_2d_slices_from_4d_volume_file(img_f: str,
                                         export_path: str) -> List[str]:
    """Slice a 4D cine into t x z 2D nrrd files named
    '<patient>__t<tt>_z<z>_img.nrrd' (ref: Dataset.py:379-516); a 3D file
    is one time step. Returns the written paths."""
    img_4d = read_image(img_f)
    nda = img_4d.array
    if nda.ndim == 3:
        nda = nda[None]
    stem = re.sub(r"\.(nii\.gz|nii|nrrd)$", "", os.path.basename(img_f))
    patient = stem.split("_")[0]
    ensure_dir(export_path)
    written = []
    for t in range(nda.shape[0]):
        for z in range(nda.shape[1]):
            path = os.path.join(export_path,
                                slice_file_name(patient, f"{t:02d}", z, "img"))
            write_image(copy_meta(MedicalImage(array=nda[t, z]), img_4d), path)
            written.append(path)
    return written


def create_2d_slices_from_4d_volume_files(img_f: str, mask_f: str,
                                          export_path: str,
                                          filter_by_mask: bool = True,
                                          slice_threshold: int = 2):
    """Slice a 4D img/mask pair into '<patient>_t<t>_z<z>_img|msk.nrrd'
    files, by default only the time steps with more than
    ``slice_threshold`` annotated slices (ref: Dataset.py:419-466).
    Returns [kept time steps, image shape]."""
    logging.info("process file: %s", img_f)
    img_4d = read_image(img_f)
    msk_4d = read_image(mask_f)
    if filter_by_mask:
        msk_nda, kept_t = filter_4d_vol(msk_4d.array, slice_threshold)
        img_nda = img_4d.array[kept_t]
    else:
        img_nda, msk_nda = img_4d.array, msk_4d.array
        kept_t = list(range(img_nda.shape[0]))
    patient = os.path.basename(img_f).split(".")[0].replace("volume_clean", "")
    ensure_dir(export_path)
    for img_3d, msk_3d, t in zip(img_nda, msk_nda, kept_t):
        for z, (img_2d, msk_2d) in enumerate(zip(img_3d, msk_3d)):
            for nda, kind in ((img_2d, "img"), (msk_2d, "msk")):
                out = copy_meta(MedicalImage(array=nda), img_4d,
                                copy_direction=False)
                write_image(out, os.path.join(
                    export_path, f"{patient}_t{t}_z{z}_{kind}.nrrd"))
    return [kept_t, list(img_nda.shape)]


def create_2d_slices_from_3d_volume_files_any_filename(
        img_f: str, mask_f: str, export_path: str) -> List[int]:
    """Slice a 3D img/mask pair into 2D nrrd files named as the originals
    with the z index before the img/msk suffix (ref: Dataset.py:467-517).
    Returns the 3D image shape."""
    logging.info("process file: %s", img_f)
    img_3d = read_image(img_f)
    msk_3d = read_image(mask_f)

    def extended_name(f_name: str, z: int) -> str:
        base = os.path.basename(f_name)
        m = re.search("_img|_msk", base)
        suffix = m.group(0) if m else ""
        return re.sub(f"{suffix}.nrrd", f"_{z}{suffix}.nrrd", base)

    ensure_dir(export_path)
    for z, (img_2d, msk_2d) in enumerate(zip(img_3d.array, msk_3d.array)):
        write_image(copy_meta(MedicalImage(array=img_2d), img_3d),
                    os.path.join(export_path, extended_name(img_f, z)))
        write_image(copy_meta(MedicalImage(array=msk_2d), img_3d),
                    os.path.join(export_path, extended_name(mask_f, z)))
    return list(img_3d.array.shape)


def create_2d_slices_from_3d_volume_files_new_naming(
        img_f: str, mask_f: Optional[str], export_path: str):
    """The ACDC 3D -> 2D slicer with 'f_'-prefixed patients,
    'f_<patient>__t<frame>_z<z>_img|msk.nrrd' (ref: Dataset.py:564-608).
    Returns [frame, image shape]."""
    logging.info("process file: %s", img_f)
    if not mask_f:
        mask_f = img_f
    img_3d = read_image(img_f)
    msk_3d = read_image(mask_f)
    patient = "f_" + os.path.basename(img_f).split("_")[0]
    frame = os.path.basename(img_f).split("frame")[1][:2]
    ensure_dir(export_path)
    for z, (img_2d, msk_2d) in enumerate(zip(img_3d.array, msk_3d.array)):
        for nda, kind in ((img_2d, "img"), (msk_2d, "msk")):
            write_image(copy_meta(MedicalImage(array=nda), img_3d),
                        os.path.join(export_path,
                                     slice_file_name(patient, frame, z, kind)))
    return [frame, list(img_3d.array.shape)]


def filter_4d_vol(nda_4d: np.ndarray, slice_threshold: int = 2
                  ) -> Tuple[np.ndarray, List[int]]:
    """Keep the time steps with more than ``slice_threshold`` masked slices
    (ref: Dataset.py:1045-1090)."""
    timesteps = []
    for t, nda_3d in enumerate(nda_4d):
        if nda_3d.max() > 0:
            masked = sum(1 for s in nda_3d if s.max() > 0)
            if masked > slice_threshold:
                timesteps.append(t)
    return nda_4d[timesteps], timesteps


# ---------------------------------------------------------------------------
# ACDC metadata (Info.cfg: ED/ES frame + pathology group)
# ---------------------------------------------------------------------------

def read_cfg_file(path: str) -> Dict[str, object]:
    """Parse an ACDC Info.cfg ('key: value' lines, yaml subset)."""
    out: Dict[str, object] = {}
    with open(path) as fh:
        for line in fh:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                out[key.strip()] = int(value)
            except ValueError:
                try:
                    out[key.strip()] = float(value)
                except ValueError:
                    out[key.strip()] = value
    return out


def get_phase_file(folder: str, phase: str = "ED", gt: bool = False) -> str:
    cfg = read_cfg_file(os.path.join(folder, "Info.cfg"))
    frame = "{:02}".format(cfg.get(phase, "NOPHASE"))
    pattern = f"*frame{frame}_gt.nii.gz" if gt else f"*frame{frame}.nii.gz"
    return glob.glob(os.path.join(folder, pattern))[0]


def get_pathology_group(folder: str) -> str:
    return str(read_cfg_file(os.path.join(folder, "Info.cfg")).get(
        "Group", "NOGROUP"))


def _first(folder: str, pattern: str) -> str:
    return sorted(glob.glob(os.path.join(folder, pattern)))[0]


def get_phase_for_patient_timestep(folder: str, timestep: int) -> str:
    cfg = read_cfg_file(os.path.join(folder, "Info.cfg"))
    if timestep == cfg.get("ED", 100):
        return "ED"
    if timestep == cfg.get("ES", 100):
        return "ES"
    return "NOPHASE"


def describe_acdc_patient_folder(folder: str) -> List[Dict]:
    """One row per file (cfg, ed, ed_gt, es, es_gt, 4d) with the patient's
    pathology: columns pathology, patient, files, phase
    (ref: Dataset.py:949-985)."""
    patient = os.path.basename(os.path.abspath(folder))
    files = [_first(folder, "*.cfg"),
             get_phase_file(folder, "ED", False),
             get_phase_file(folder, "ED", True),
             get_phase_file(folder, "ES", False),
             get_phase_file(folder, "ES", True),
             _first(folder, "*4d.nii.gz")]
    pathology = get_pathology_group(folder)
    return [{"pathology": pathology, "patient": patient, "files": f,
             "phase": phase}
            for f, phase in zip(files, ("cfg", "ed", "ed_gt", "es", "es_gt",
                                        "4d"))]


def get_acdc_dataset_as_df(path: str) -> List[Dict]:
    """Every ACDC patient folder under ``path`` as
    ``describe_acdc_patient_folder`` rows (ref: Dataset.py:1026-1042); a
    path with no patient folder raises, as pandas' concat of nothing
    does."""
    folders = sorted(glob.glob(os.path.join(path, "**/")))
    if not folders:
        raise ValueError(f"no patient folders under {path}")
    return [row for f in folders for row in describe_acdc_patient_folder(f)]


def get_acdc_pathologies(path: str) -> Dict[str, str]:
    """Patient id -> pathology group of every patient folder under ``path``
    (the join cmrtpu's evaluation takes from ``get_acdc_dataset_as_df``).
    A folder must hold what that table indexes — an Info.cfg, the ED and ES
    frames with their ``_gt`` masks and a ``*4d.nii.gz`` — or this raises
    as cmrtpu does; so does a path with no patient folder."""
    return {r["patient"]: r["pathology"] for r in get_acdc_dataset_as_df(path)}


# ---------------------------------------------------------------------------
# k-fold split construction + fold-file resolution
# ---------------------------------------------------------------------------

def kfold_split(n: int, k: int, seed: int = 42
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) index arrays of scikit-learn's ``KFold(k,
    shuffle=True, random_state=seed).split`` over n samples: the indices
    shuffled by ``RandomState(seed)`` cut into consecutive folds of n // k,
    one more in each of the first n % k; both arrays ascending."""
    if not 2 <= k <= n:
        raise ValueError(f"k-fold needs 2 <= k <= n samples, got k={k}, n={n}")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(k, n // k)
    sizes[:n % k] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def filter_x_by_patient_ids(x: Sequence[str], patient_ids: Sequence[str],
                            modality: str = "test",
                            columns=KFOLD_COLUMNS, fold: int = 0,
                            pathology: Optional[str] = None,
                            filter: bool = True) -> List[Dict]:
    """Fold-table rows of a file list, kept to ``patient_ids`` unless
    ``filter`` is False (ref: Dataset.py:758-787). Each row has
    ``columns`` in their order, then any of the table's own columns that
    ``columns`` lacks (NaN where ``columns`` names one it does not
    fill)."""
    keys = list(columns) + [c for c in KFOLD_COLUMNS if c not in columns]
    files = [e for e in x if get_patient(e) in patient_ids] if filter \
        else list(x)
    rows = []
    for e in files:
        row = dict.fromkeys(keys, math.nan)
        row.update(x_path=e, y_path=e.replace("img", "msk"), fold=fold,
                   modality=modality, patient=get_patient(e),
                   pathology=pathology)
        rows.append(row)
    return rows


def get_kfolded_data(kfolds: int = 4, path_to_data: str = "data/2D/",
                     extract_patient_id=get_patient) -> List[Dict]:
    """Patient-level k-fold split of a 2D slice directory as fold-table rows
    (ref: Dataset.py:680-757), in cmrtpu's row order: the folds last to
    first, each fold's train rows before its test rows, files sorted."""
    x = sorted(glob.glob(os.path.join(path_to_data, "**/*img.nrrd")))
    if not x:
        x = sorted(glob.glob(os.path.join(path_to_data, "*img.nrrd")))
    logging.info("found: %d files", len(x))
    patients = sorted({extract_patient_id(f) for f in x})
    rows: List[Dict] = []
    for f, (train_idx, test_idx) in enumerate(kfold_split(len(patients),
                                                          kfolds)):
        fold_rows = []
        for modality, idx in (("train", train_idx), ("test", test_idx)):
            fold_rows += filter_x_by_patient_ids(
                x, {patients[i] for i in idx}, modality, fold=f)
        rows = fold_rows + rows
    return rows


def write_kfold_csv(rows: Sequence[Dict], path: str,
                    columns: Sequence[str] = KFOLD_COLUMNS) -> None:
    """Fold-table rows as df_kfold.csv, written as pandas'
    ``to_csv(index=False)`` writes them (None or NaN as an empty cell)."""
    def cell(v):
        return "" if v is None or (isinstance(v, float) and math.isnan(v)) \
            else v

    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([cell(row[c]) for c in columns])


def create_acdc_dataframe_for_cv(path_to_data: str, kfolds: int = 4,
                                 original_acdc_dir: str = "original/",
                                 img_pattern: str = "*img.nrrd") -> List[Dict]:
    """The paper's pathology-stratified patient-level k-fold CV table
    (ref: Dataset.py:869-948) as rows: per pathology group, in the order
    the groups first appear under ``original_acdc_dir``, its patients split
    by ``kfold_split``; each fold's train rows before its test rows, and
    each new fold put before the folds so far, as cmrtpu's
    ``pd.concat([new, df_folds], sort=True)`` does. Columns in
    ``ACDC_CV_COLUMNS`` order."""
    x = sorted(glob.glob(os.path.join(path_to_data, f"**/{img_pattern}")))
    if not x:
        x = sorted(glob.glob(os.path.join(path_to_data, img_pattern)))
    table = get_acdc_dataset_as_df(original_acdc_dir)
    pathologies = list(dict.fromkeys(r["pathology"] for r in table))
    rows: List[Dict] = []
    for pathology in pathologies:
        patients = list(dict.fromkeys(r["patient"] for r in table
                                      if r["pathology"] == pathology))
        for fold, (train_idx, test_idx) in enumerate(
                kfold_split(len(patients), kfolds)):
            new = []
            for modality, idx in (("train", train_idx), ("test", test_idx)):
                new += filter_x_by_patient_ids(
                    x, [patients[i] for i in idx], modality, fold=fold,
                    pathology=pathology)
            rows = new + rows
    return [{c: r[c] for c in ACDC_CV_COLUMNS} for r in rows]


def write_acdc_cv_csv(rows: Sequence[Dict], path: str) -> None:
    """``create_acdc_dataframe_for_cv`` rows as cmrtpu's
    ``to_csv(index=False)`` of its DataFrame writes them."""
    write_kfold_csv(rows, path, ACDC_CV_COLUMNS)


def fold_patients(path_to_folds_df: str, fold: int,
                  modality: str = "test") -> List[str]:
    """Sorted unique patients of one fold and modality in a df_kfold.csv."""
    with open(path_to_folds_df, newline="", encoding="utf-8") as fh:
        return sorted({row["patient"] for row in csv.DictReader(fh)
                       if int(float(row["fold"])) == int(fold)
                       and row["modality"] == modality})


def get_trainings_files(data_path: str, fold: int = 0,
                        path_to_folds_df: str = "df_kfold.csv"
                        ) -> Tuple[List[str], List[str], List[str], List[str]]:
    """Train/val file lists of one fold: glob *img.nrrd / *msk.nrrd, keep
    the files of the fold's train and test patients (case-insensitive)."""
    x = sorted(glob.glob(os.path.join(data_path, "*img.nrrd")))
    y = sorted(glob.glob(os.path.join(data_path, "*msk.nrrd")))
    if not x:
        logging.info("no files found, try clean.nrrd/mask.nrrd pattern")
        x = sorted(glob.glob(os.path.join(data_path, "*clean.nrrd")))
        y = sorted(glob.glob(os.path.join(data_path, "*mask.nrrd")))

    patients = {"train": set(), "test": set()}
    with open(path_to_folds_df, newline="", encoding="utf-8") as fh:
        for row in csv.DictReader(fh):
            if int(float(row["fold"])) == int(fold) \
                    and row["modality"] in patients:
                patients[row["modality"]].add(row["patient"].lower())
    logging.info("Found %d images/masks in %s", len(x), data_path)

    def filter_fold(files, patient_set):
        return sorted(f for f in files if get_patient(f).lower() in patient_set)

    x_train = filter_fold(x, patients["train"])
    y_train = filter_fold(y, patients["train"])
    x_test = filter_fold(x, patients["test"])
    y_test = filter_fold(y, patients["test"])
    assert len(x_train) == len(y_train), "len(x_train) != len(y_train)"
    return x_train, y_train, x_test, y_test


def load_acdc_files(data_path: str) -> Tuple[List[str], List[str]]:
    """Original ACDC nii.gz pairs: frameXX.nii.gz + frameXX_gt.nii.gz."""
    y = sorted(glob.glob(os.path.join(data_path, "**/*frame*_gt.nii.gz")))
    return [f.replace("_gt", "") for f in y], y


# ---------------------------------------------------------------------------
# file-list / filename helpers (reference long tail)
# ---------------------------------------------------------------------------

def get_img_msk_files_from_split_dir(path: str) -> Tuple[List[str], List[str]]:
    """All img/msk nrrd pairs of a split directory, else its original ACDC
    nii.gz pairs (ref: Dataset.py:1110-1126)."""
    assert os.path.exists(path), f"Path: {path} does not exist"
    images = sorted(glob.glob(os.path.join(path, "*img.nrrd")))
    masks = sorted(glob.glob(os.path.join(path, "*msk.nrrd")))
    if not images:
        return load_acdc_files(path)
    return images, masks


def get_patients(path: str) -> List[str]:
    """Unique patient ids of a split directory (ref: Dataset.py:1183-1188)."""
    images, _ = get_img_msk_files_from_split_dir(path)
    return sorted({get_patient(f) for f in images})


def get_z_position_from_filename(f_name: str) -> int:
    """z index of a '<patient>__t<frame>_z<z>_img.nrrd' name
    (ref: Dataset.py:1128-1129)."""
    return int(os.path.basename(f_name).split("_")[-2].replace("z", ""))


def get_t_position_from_filename(f_name: str):
    """Frame token of the slice naming, an int where it parses
    (ref: Dataset.py:1132-1136)."""
    token = os.path.basename(f_name).split("_")[-3].replace("t", "")
    try:
        return int(token)
    except ValueError:
        return token


def is_patient_in_df(row: Dict, rows: Sequence[Dict],
                     col: str = "patient_unique") -> bool:
    """(ref: is_patient_in_df, Dataset.py:1139-1146)"""
    return any(row[col] == r[col] for r in rows)


def get_n_patients(rows: Sequence[Dict], n: int = 1) -> List[Dict]:
    """The fold-0 rows of n patients drawn with replacement by numpy's
    MT19937 seeded 42, with modality set to 'train' (ref: get_n_patients,
    Dataset.py:789-817). cmrtpu draws from numpy's global generator after
    ``np.random.seed(42)``; a ``RandomState(42)`` gives the same draws and
    leaves the global generator alone."""
    patients = sorted({r["patient"] for r in rows})
    chosen = set(np.random.RandomState(42).choice(patients, size=n).tolist())
    return [dict(r, modality="train") for r in rows
            if int(float(r["fold"])) == 0 and r["patient"] in chosen]


def _read_fold_rows(path: str) -> List[Dict]:
    with open(path, newline="", encoding="utf-8") as fh:
        return list(csv.DictReader(fh))


def get_train_data_from_df(first_df: str, second_df: Optional[str] = None,
                           n_second_df: int = 0,
                           n_first_df: Optional[int] = None, fold: int = 0):
    """Train/val file lists of one fold of a df_kfold.csv, optionally with
    n patients of a second one mixed in (cross-dataset training, ref:
    get_train_data_from_df, Dataset.py:820-866). Returns (x_train,
    y_train, x_val, y_val, extend_info)."""
    extend = {"EXTRA_PATIENTS": [], "EXTRA_IMAGES": 0}
    rows = _read_fold_rows(first_df)
    if n_first_df:
        rows = get_n_patients(rows, n_first_df)
    if second_df:
        extra = get_n_patients(_read_fold_rows(second_df), n_second_df)
        rows = rows + extra
        extend["EXTRA_PATIENTS"] = sorted({r["patient"] for r in extra})
        extend["EXTRA_IMAGES"] = len(extra)
    if rows and "fold" in rows[0]:
        rows = [r for r in rows if int(float(r["fold"])) == fold]

    def files(modality, col):
        return sorted(r[col] for r in rows if r["modality"] == modality)

    return (files("train", "x_path"), files("train", "y_path"),
            files("test", "x_path"), files("test", "y_path"), extend)


# ---------------------------------------------------------------------------
# 4D <-> 3D volume helpers (reference long tail)
# ---------------------------------------------------------------------------

def split_4d_into_3d(img_4d: MedicalImage) -> List[MedicalImage]:
    """Per-t 3D images of a 4D image with its geometry
    (ref: split_one_4d_sitk_in_list_of_3d_sitk, Dataset.py:319-344)."""
    return [copy_meta(MedicalImage(array=vol3d), img_4d)
            for vol3d in img_4d.array]


def create_3d_volumes_from_4d_files(img_f: str, mask_f: str, export_path: str,
                                    slice_threshold: int = 2) -> List[int]:
    """Per-t 3D img/msk nrrd pairs '<patient>_t<t>_img|msk.nrrd' of the
    time steps whose mask has more than ``slice_threshold`` annotated
    slices (ref: Dataset.py:346-377). Returns the kept time steps."""
    img_4d = read_image(img_f)
    msk_4d = read_image(mask_f)
    msk_nda, kept_t = filter_4d_vol(msk_4d.array, slice_threshold)
    ensure_dir(export_path)
    patient = os.path.basename(img_f).split(".")[0]
    for vol3d, msk3d, t in zip(img_4d.array[kept_t], msk_nda, kept_t):
        for nda, kind in ((vol3d, "img"), (msk3d, "msk")):
            write_image(copy_meta(MedicalImage(array=nda), img_4d),
                        os.path.join(export_path,
                                     f"{patient}_t{t}_{kind}.nrrd"))
    return list(kept_t)


def create_4d_volumes_from_4d_files(img_f: str, mask_f: str,
                                    export_path: str,
                                    slice_threshold: int = 2):
    """The 4D img/mask pair cut to its annotated time steps, written as
    '<patient>_img|msk.nrrd' (ref: Dataset.py:253-283). Returns [kept
    time steps, image shape]."""
    logging.info("process file: %s", img_f)
    img_4d = read_image(img_f)
    msk_4d = read_image(mask_f)
    msk_nda, kept_t = filter_4d_vol(msk_4d.array, slice_threshold)
    img_nda = img_4d.array[kept_t]
    patient = os.path.basename(img_f).split(".")[0].replace("volume_clean", "")
    ensure_dir(export_path)
    for nda, kind in ((img_nda, "img"), (msk_nda, "msk")):
        write_image(copy_meta(MedicalImage(array=nda), img_4d),
                    os.path.join(export_path, f"{patient}_{kind}.nrrd"))
    return [kept_t, list(img_nda.shape)]


def save_3d(nda: np.ndarray, fname: str) -> None:
    """An ndarray as an image file with default geometry
    (ref: save_3d, Dataset.py:53-56)."""
    write_image(MedicalImage(array=np.asarray(nda)), fname)


def save_phases(nda: np.ndarray, export_dir: str, suffix: str) -> None:
    """Each time step of a [t, z, y, x, c] volume as a [c, x, y, z] file,
    ``suffix`` with '.nii' -> '_<t>_.nii' (ref: save_phases,
    Dataset.py:83-101)."""
    f_name = os.path.join(export_dir, suffix)
    nda = np.einsum("tzyxc->cxyzt", np.asarray(nda))
    for t in range(nda.shape[-1]):
        save_3d(nda[..., t], f_name.replace(".nii", f"_{t}_.nii"))


def save_all_3d_vols_new(volumes: List[np.ndarray], vol_suffixes: List[str],
                         exp_path: str, exp: str = "example_flows") -> None:
    """``save_phases`` of each [t, z, y, x, c] volume under
    ``<exp_path>/<exp>/`` (ref: save_all_3d_vols_new, Dataset.py:59-80)."""
    assert isinstance(volumes, list) and isinstance(vol_suffixes, list)
    target = os.path.join(exp_path, exp)
    logging.info(target)
    ensure_dir(target)
    for nda, suffix in zip(volumes, vol_suffixes):
        save_phases(nda, target, suffix)


def get_3d_img_msk_files(path: str) -> Tuple[List[str], List[str]]:
    """img/msk nrrd pairs of ``images/`` and ``masks/``, else the original
    ACDC nii.gz pairs (ref: get_3d_img_msk_files, Dataset.py:1205-1221)."""
    assert os.path.exists(path), f"Path: {path} does not exist"
    images = sorted(glob.glob(os.path.join(path, "images/*img.nrrd")))
    masks = sorted(glob.glob(os.path.join(path, "masks/*msk.nrrd")))
    if not images:
        logging.info("no nrrd files found, try to load acdc files.")
        return load_acdc_files(path)
    return images, masks


def save_gt_and_pred(gt: np.ndarray, pred: np.ndarray, exp_path: str,
                     patient: str,
                     phases: Sequence[str] = ("ED", "MS", "ES", "PF", "MD")
                     ) -> None:
    """Per-phase gt and pred volumes of [t, z, y, x, c] arrays as [c, x, y,
    z] files ``gt_m/`` and ``pred_m/<patient>_<phase>.nii``
    (ref: save_gt_and_pred, Dataset.py:22-51)."""
    for sub in ("gt_m", "pred_m"):
        ensure_dir(os.path.join(exp_path, sub))
    gt_c = np.einsum("tzyxc->cxyzt", np.asarray(gt))
    pred_c = np.einsum("tzyxc->cxyzt", np.asarray(pred))
    for t, phase in enumerate(phases[:gt.shape[0]]):
        for nda, sub in ((gt_c, "gt_m"), (pred_c, "pred_m")):
            write_image(MedicalImage(array=nda[..., t]),
                        os.path.join(exp_path, sub, f"{patient}_{phase}.nii"))


def describe_image(img) -> str:
    """A loggable summary of an image's geometry (MedicalImage or ndarray;
    ref: Dataset.py:1080-1095)."""
    if isinstance(img, np.ndarray):
        img = MedicalImage(array=img)
    text = "\n".join([f"size: {img.size}", f"spacing: {img.spacing}",
                      f"origin: {img.origin}", f"direction: {img.direction}",
                      f"dtype: {img.array.dtype}"])
    logging.info(text)
    return text
