"""File naming and fold lists — the part of ``cmrtpu/data/dataset.py`` that
training needs, without pandas (the card has none).

Conventions kept bit-exact with the reference so its df_kfold.csv files
keep working: 2D slice names '<patient>__t<frame>_z<z>_img|msk.nrrd', fold
table columns [fold, x_path, y_path, modality, patient(, pathology)], and the
patient-id rules (ref: src/data/Dataset.py:552-559, :609-623, :625-678).
"""

from __future__ import annotations

import csv
import glob
import logging
import os
import re
from typing import List, Tuple


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
