"""File naming, volume slicing, ACDC metadata and fold tables — the part of
``cmrtpu/data/dataset.py`` that training, prediction and evaluation need,
without pandas or scikit-learn (the card has neither).

Conventions kept bit-exact with the reference so its df_kfold.csv files
keep working: 2D slice names '<patient>__t<frame>_z<z>_img|msk.nrrd', fold
table columns [x_path, y_path, fold, modality, patient, pathology], and the
patient-id rules (ref: src/data/Dataset.py:552-559, :609-623, :625-678).
``get_kfolded_data`` writes the same df_kfold.csv bytes as cmrtpu's
``get_kfolded_data(...).to_csv(index=False)``.
"""

from __future__ import annotations

import csv
import glob
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.io.geometry import copy_meta
from cmrtpu_torch.utils.io_utils import ensure_dir

KFOLD_COLUMNS = ("x_path", "y_path", "fold", "modality", "patient",
                 "pathology")


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


def get_acdc_pathologies(path: str) -> Dict[str, str]:
    """Patient id -> pathology group of every patient folder under ``path``
    (the join cmrtpu's evaluation takes from ``get_acdc_dataset_as_df``,
    ref: Dataset.py:949-985, :1026-1042). A folder must hold what cmrtpu's
    table indexes — an Info.cfg, the ED and ES frames with their ``_gt``
    masks and a ``*4d.nii.gz`` — or this raises as cmrtpu does; so does a
    path with no patient folder."""
    folders = sorted(glob.glob(os.path.join(path, "**/")))
    if not folders:
        raise ValueError(f"no patient folders under {path}")
    out: Dict[str, str] = {}
    for folder in folders:
        # look up the files of cmrtpu's table in its order: a missing one
        # raises here as it does there
        _first(folder, "*.cfg")
        for phase in ("ED", "ES"):
            for gt in (False, True):
                get_phase_file(folder, phase, gt)
        _first(folder, "*4d.nii.gz")
        patient = os.path.basename(os.path.abspath(folder))
        out.setdefault(patient, get_pathology_group(folder))
    return out


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
            chosen = {patients[i] for i in idx}
            fold_rows += [{"x_path": e, "y_path": e.replace("img", "msk"),
                           "fold": f, "modality": modality,
                           "patient": get_patient(e), "pathology": None}
                          for e in x if get_patient(e) in chosen]
        rows = fold_rows + rows
    return rows


def write_kfold_csv(rows: Sequence[Dict], path: str) -> None:
    """Fold-table rows as df_kfold.csv, written as pandas'
    ``to_csv(index=False)`` writes them (None as an empty cell)."""
    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(KFOLD_COLUMNS)
        for row in rows:
            writer.writerow(["" if row[c] is None else row[c]
                             for c in KFOLD_COLUMNS])


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
