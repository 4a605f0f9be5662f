"""CLI: build the 2D training dataset.

``python -m cmrtpu_torch.cli.make_dataset -data_root <root> -acdc_data <acdc>``

Counterpart of ``cmrtpu/cli/make_dataset.py`` (flag parity with
``python src/data/make_dataset.py -data_root <root> -acdc_data <acdc>``):
pairs the original ACDC CMR volumes ``<acdc>/*/*frameYY.nii.gz`` with the
RVIP masks ``<root>/**/*rvip.nrrd``, slices them into per-z 2D nrrd files
under ``<root>/2D`` and, when ``<root>/df_kfold.csv`` is missing, writes a
patient-level k-fold table with min(4, patients) folds. cmrtpu first tries
to download the RVIP label archive; this CLI does not download anything and
expects the masks under ``<root>/io``.
"""

import argparse
import glob
import logging
import os


def main(data_root: str, acdc_path: str) -> None:
    from cmrtpu_torch.data.dataset import (
        create_2d_slices_from_3d_volume_files, get_kfolded_data, get_patient,
        write_kfold_csv)
    from cmrtpu_torch.utils.io_utils import ensure_dir

    ensure_dir(data_root)
    io_dir = os.path.join(data_root, "io")
    if not glob.glob(os.path.join(io_dir, "*rvip.nrrd")):
        logging.warning("no RVIP masks under %s: cmrtpu_torch downloads "
                        "nothing, so the masks are expected there", io_dir)

    imgs = sorted(glob.glob(os.path.join(acdc_path,
                                         "*/*frame[0-9][0-9].nii.gz")))
    masks = sorted(glob.glob(os.path.join(data_root, "**/*rvip.nrrd"),
                             recursive=True))
    logging.info("found %d images, %d rvip masks", len(imgs), len(masks))
    assert len(imgs) == len(masks), (
        f"image/mask count mismatch: {len(imgs)} vs {len(masks)}")

    export = os.path.join(data_root, "2D")
    ensure_dir(export)
    for img_f, msk_f in zip(imgs, masks):
        create_2d_slices_from_3d_volume_files(img_f, msk_f, export)
    logging.info("2D slices written to %s", export)

    df_path = os.path.join(data_root, "df_kfold.csv")
    if not os.path.exists(df_path):
        n_patients = len({get_patient(f) for f in glob.glob(
            os.path.join(export, "*img.nrrd"))})
        kfolds = min(4, n_patients)  # tiny smoke datasets get fewer folds
        if kfolds >= 2:
            write_kfold_csv(get_kfolded_data(kfolds=kfolds,
                                             path_to_data=export), df_path)
            logging.info("k-fold table (%d folds) written to %s", kfolds,
                         df_path)
        else:
            logging.warning("only %d patient(s) — skipping df_kfold.csv",
                            n_patients)


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser(description="build the RVIP 2D dataset")
    parser.add_argument("-data_root", action="store", default=None)
    parser.add_argument("-acdc_data", action="store", default=None)
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")
    main(args.data_root, args.acdc_data)


if __name__ == "__main__":
    cli()
