"""First-party NIfTI-1 codec (.nii / .nii.gz).

Replaces SimpleITK's NIfTI reading of the original ACDC volumes
(ref: src/models/predict_model.py:169, src/models/evaluate_cv.py:678-684).
NIfTI stores geometry in RAS+; like ITK we convert to LPS by negating the x
and y rows of the affine, so spacing/origin/direction agree with what the
reference saw through sitk.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

from cmrtpu_torch.io.geometry import MedicalImage
from cmrtpu_torch.native import cmrio

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_blob(path: str) -> bytes:
    blob = cmrio.read_file_bytes(path)
    if blob[:2] == b"\x1f\x8b":
        blob = cmrio.inflate(blob)
    return blob


def _quaternion_to_matrix(b: float, c: float, d: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(a2) if a2 > 0 else 0.0
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
    ])


def read_nifti(path: str) -> MedicalImage:
    blob = _read_blob(path)
    return decode_nifti(blob)


def decode_nifti(blob: bytes) -> MedicalImage:
    hdr = blob[:348]
    endian = "<"
    (sizeof_hdr,) = struct.unpack_from(endian + "i", hdr, 0)
    if sizeof_hdr != 348:
        endian = ">"
        (sizeof_hdr,) = struct.unpack_from(endian + "i", hdr, 0)
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file")

    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = int(dim[0])
    shape_xyz = [int(d) for d in dim[1:1 + ndim]]           # x fastest
    (datatype,) = struct.unpack_from(endian + "h", hdr, 70)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", hdr, 112)
    qform_code, sform_code = struct.unpack_from(endian + "2h", hdr, 252)
    qb, qc, qd, qx, qy, qz = struct.unpack_from(endian + "6f", hdr, 256)
    srow = np.array(struct.unpack_from(endian + "12f", hdr, 280)).reshape(3, 4)

    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape_xyz))
    offset = int(vox_offset) if vox_offset else 352
    array = np.frombuffer(blob[offset:offset + count * dtype.itemsize], dtype=dtype)
    array = array.reshape(tuple(reversed(shape_xyz)))       # -> [(t,) z, y, x]
    array = np.ascontiguousarray(array.astype(dtype.newbyteorder("=")))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        if scl_slope == 0.0:
            scl_slope = 1.0
        array = array.astype(np.float32) * scl_slope + scl_inter

    # affine in RAS: physical = A @ [i, j, k, 1]
    if sform_code > 0:
        affine = srow
    elif qform_code > 0:
        rot = _quaternion_to_matrix(qb, qc, qd)
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        scale = np.diag([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine = np.concatenate([rot @ scale, [[qx], [qy], [qz]]], axis=1)
    else:
        affine = np.concatenate(
            [np.diag([pixdim[1], pixdim[2], pixdim[3]]), np.zeros((3, 1))], axis=1)

    # RAS -> LPS (ITK convention): negate x and y rows
    affine = affine * np.array([[-1.0], [-1.0], [1.0]])

    spacing3 = np.linalg.norm(affine[:, :3], axis=0)
    spacing3 = np.where(spacing3 > 0, spacing3, 1.0)
    direction3 = affine[:, :3] / spacing3
    origin3 = affine[:, 3]

    spatial = min(ndim, 3)
    spacing = list(spacing3[:spatial]) + [float(pixdim[i + 1]) if pixdim[i + 1] > 0 else 1.0
                                          for i in range(spatial, ndim)]
    origin = list(origin3[:spatial]) + [0.0] * (ndim - spatial)
    direction = np.eye(ndim)
    direction[:spatial, :spatial] = direction3[:spatial, :spatial]

    return MedicalImage(array=array, spacing=tuple(spacing), origin=tuple(origin),
                        direction=tuple(direction.flatten()), metadata={})


def encode_nifti(img: MedicalImage) -> bytes:
    array = np.ascontiguousarray(img.array)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    if array.dtype not in _DTYPE_CODES:
        array = array.astype(np.float32)
    ndim = array.ndim
    shape_xyz = list(reversed(array.shape))

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [ndim] + shape_xyz + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[array.dtype])
    struct.pack_into("<h", hdr, 72, array.dtype.itemsize * 8)
    pix = [1.0] + [float(s) for s in img.spacing] + [1.0] * (7 - ndim)
    struct.pack_into("<8f", hdr, 76, *pix[:8])
    struct.pack_into("<f", hdr, 108, 352.0)              # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)          # scl_slope / inter
    struct.pack_into("<2h", hdr, 252, 0, 1)              # qform=0, sform=1

    dmat = np.eye(3)
    spatial = min(ndim, 3)
    dmat[:spatial, :spatial] = img.direction_matrix[:spatial, :spatial]
    spacing3 = np.array(list(img.spacing[:spatial]) + [1.0] * (3 - spatial))
    origin3 = np.array(list(img.origin[:spatial]) + [0.0] * (3 - spatial))
    affine = dmat * spacing3[None, :]
    affine = np.concatenate([affine, origin3[:, None]], axis=1)
    affine = affine * np.array([[-1.0], [-1.0], [1.0]])  # LPS -> RAS
    struct.pack_into("<12f", hdr, 280, *affine.flatten())
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")

    return bytes(hdr) + b"\x00" * 4 + array.tobytes()


def write_nifti(img: MedicalImage, path: str) -> None:
    from cmrtpu_torch.utils.io_utils import ensure_dir
    import os
    ensure_dir(os.path.dirname(os.path.abspath(path)))
    blob = encode_nifti(img)
    if path.lower().endswith(".gz"):
        blob = cmrio.deflate_gzip(blob, level=1)
    with open(path, "wb") as fh:
        fh.write(blob)
