"""First-party NRRD codec (read: raw/gzip encodings, write: gzip).

Replaces SimpleITK's nrrd IO used throughout the reference for the sliced 2D
training files and the prediction outputs (ref: src/data/Dataset.py:552-559,
src/models/predict_model.py:184-186). Geometry is translated to/from the sitk
convention: ``space directions`` column vectors are direction-matrix columns
scaled by per-axis spacing.
"""

from __future__ import annotations

import gzip
import re
import zlib
from typing import Dict, Tuple

import numpy as np

from cmrtpu_torch.io.geometry import MedicalImage
from cmrtpu_torch.native import cmrio

_TYPE_TO_DTYPE = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8, "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "signed short int": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "unsigned short int": np.uint16,
    "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32, "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64, "uint64": np.uint64,
    "float": np.float32, "double": np.float64,
}
_DTYPE_TO_TYPE = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}

_VEC_RE = re.compile(r"\(([^)]*)\)")


def _parse_vectors(value: str):
    """Parse 'none (a,b,c) (d,e,f)' into [None, np.array, np.array]."""
    out = []
    for token in value.split():
        if token.lower() == "none":
            out.append(None)
    for m in _VEC_RE.finditer(value):
        out.append(np.array([float(x) for x in m.group(1).split(",")]))
    # preserve ordering when 'none' and vectors are interleaved
    ordered = []
    vec_iter = iter([v for v in out if v is not None])
    for token in re.findall(r"none|\([^)]*\)", value, flags=re.IGNORECASE):
        ordered.append(None if token.lower() == "none" else next(vec_iter))
    return ordered if ordered else out


def read_nrrd(path: str) -> MedicalImage:
    return decode_nrrd(cmrio.read_file_bytes(path))


def decode_nrrd(blob: bytes) -> MedicalImage:
    if not blob.startswith(b"NRRD"):
        raise ValueError("not a NRRD file")
    header_end = blob.find(b"\n\n")
    alt = blob.find(b"\r\n\r\n")
    if alt != -1 and (header_end == -1 or alt < header_end):
        header_end, sep = alt, 4
    else:
        sep = 2
    if header_end == -1:
        raise ValueError("NRRD header terminator not found")
    header_text = blob[:header_end].decode("ascii", errors="replace")
    payload = blob[header_end + sep:]

    fields: Dict[str, str] = {}
    metadata: Dict[str, str] = {}
    for line in header_text.splitlines()[1:]:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":=" in line:
            key, value = line.split(":=", 1)
            metadata[key.strip()] = value.strip()
        elif ":" in line:
            key, value = line.split(":", 1)
            fields[key.strip().lower()] = value.strip()

    dim = int(fields["dimension"])
    sizes = [int(s) for s in fields["sizes"].split()]  # fastest (x) first
    dtype = np.dtype(_TYPE_TO_DTYPE[fields["type"].lower()])
    if fields.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")

    encoding = fields.get("encoding", "raw").lower()
    n_bytes = int(np.prod(sizes)) * dtype.itemsize
    if encoding in ("gzip", "gz"):
        raw = cmrio.inflate(payload, size_hint=n_bytes)
    elif encoding == "raw":
        raw = payload
    else:
        raise ValueError(f"unsupported NRRD encoding: {encoding}")
    array = np.frombuffer(raw[:n_bytes], dtype=dtype).reshape(tuple(reversed(sizes)))
    array = np.ascontiguousarray(array.astype(dtype.newbyteorder("=")))

    spacing = [1.0] * dim
    direction = np.eye(dim)
    if "space directions" in fields:
        vectors = _parse_vectors(fields["space directions"])
        for axis, vec in enumerate(vectors[:dim]):
            if vec is None:
                continue
            norm = float(np.linalg.norm(vec))
            if norm > 0:
                spacing[axis] = norm
                direction[:len(vec), axis] = vec / norm
    elif "spacings" in fields:
        for axis, s in enumerate(fields["spacings"].split()[:dim]):
            if s.lower() != "nan":
                spacing[axis] = float(s)

    origin = [0.0] * dim
    if "space origin" in fields:
        vec = _parse_vectors(fields["space origin"])[0]
        if vec is not None:
            origin[:len(vec)] = [float(v) for v in vec]

    return MedicalImage(array=array, spacing=tuple(spacing), origin=tuple(origin),
                        direction=tuple(direction.flatten()), metadata=metadata)


def encode_nrrd(img: MedicalImage, compress: bool = True) -> bytes:
    array = np.ascontiguousarray(img.array)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    dtype = array.dtype.newbyteorder("=")
    if np.dtype(dtype) not in _DTYPE_TO_TYPE:
        array = array.astype(np.float32)
        dtype = array.dtype
    dim = array.ndim
    sizes = " ".join(str(s) for s in reversed(array.shape))
    dmat = img.direction_matrix
    dirs = " ".join(
        "(" + ",".join(repr(float(dmat[r, c] * img.spacing[c])) for r in range(dim)) + ")"
        for c in range(dim))
    origin = "(" + ",".join(repr(float(o)) for o in img.origin) + ")"
    space = {2: "left-posterior", 3: "left-posterior-superior"}.get(dim)

    lines = ["NRRD0004",
             "# produced by cmrtpu",
             f"type: {_DTYPE_TO_TYPE[np.dtype(dtype)]}",
             f"dimension: {dim}",
             f"sizes: {sizes}",
             "endian: little",
             f"encoding: {'gzip' if compress else 'raw'}"]
    if space:
        lines.append(f"space: {space}")
    else:
        lines.append(f"space dimension: {dim}")
    lines += [f"space directions: {dirs}", f"space origin: {origin}"]
    for key, value in img.metadata.items():
        if ":=" not in key and "\n" not in str(value):
            lines.append(f"{key}:={value}")
    header = ("\n".join(lines) + "\n\n").encode("ascii", errors="replace")
    payload = array.tobytes()
    if compress:
        # gzip container (not bare zlib) for maximal reader compatibility
        payload = cmrio.deflate_gzip(payload, level=1)
    return header + payload


def write_nrrd(img: MedicalImage, path: str, compress: bool = True) -> None:
    from cmrtpu_torch.utils.io_utils import ensure_dir
    import os
    ensure_dir(os.path.dirname(os.path.abspath(path)))
    with open(path, "wb") as fh:
        fh.write(encode_nrrd(img, compress=compress))


def _size_spacing(img: MedicalImage) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    return img.size, img.spacing
