"""Host-side medical image IO: NRRD + NIfTI codecs and the MedicalImage geometry model.

Replaces the reference's SimpleITK dependency (ref: src/data/Dataset.py:163-250,
src/data/Preprocess.py:137-227) with first-party codecs. File bytes are decoded
into numpy arrays ordered [($t$,) $z$, $y$, $x$] — the same index order
``sitk.GetArrayFromImage`` produces — while geometry (spacing/origin/direction)
is kept in x,y,z order like the sitk API, so all downstream parity code can
keep the reference's conventions. The port's own copy of ``cmrtpu/io``:
the files it writes are byte-equal to ``cmrtpu``'s.
"""

from cmrtpu_torch.io.geometry import MedicalImage
from cmrtpu_torch.io.nifti import read_nifti, write_nifti
from cmrtpu_torch.io.nrrd import read_nrrd, write_nrrd


def read_image(path: str, dtype=None) -> MedicalImage:
    """Read .nrrd / .nii / .nii.gz by extension (ref: sitk.ReadImage call sites)."""
    lower = path.lower()
    if lower.endswith(".nrrd"):
        img = read_nrrd(path)
    elif lower.endswith((".nii", ".nii.gz")):
        img = read_nifti(path)
    else:
        raise ValueError(f"unsupported image format: {path}")
    if dtype is not None:
        img = img.astype(dtype)
    return img


def write_image(img: MedicalImage, path: str) -> None:
    """Write .nrrd / .nii / .nii.gz by extension (ref: sitk.WriteImage call sites)."""
    lower = path.lower()
    if lower.endswith(".nrrd"):
        write_nrrd(img, path)
    elif lower.endswith((".nii", ".nii.gz")):
        write_nifti(img, path)
    else:
        raise ValueError(f"unsupported image format: {path}")


__all__ = ["MedicalImage", "read_image", "write_image",
           "read_nrrd", "write_nrrd", "read_nifti", "write_nifti"]
