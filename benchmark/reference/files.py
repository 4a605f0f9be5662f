"""The benchmark's own codecs: a NIfTI-1 writer for the studies it serves
and an NRRD reader for the label maps the program writes back. Neither
uses the program's readers or writers, so the two sides never share a
codec.

Geometry follows ITK: NIfTI stores RAS, ITK reads LPS (x and y negated).
The studies carry an identity direction in LPS, so the sform is
diag(-sx, -sy, sz) with the origin's x and y negated.
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict

import numpy as np

_NIFTI_TYPES = {np.dtype(np.int16): (4, 16), np.dtype(np.float32): (16, 32),
                np.dtype(np.uint8): (2, 8)}
_NRRD_TYPES = {"uint8": np.uint8, "unsigned char": np.uint8,
               "uchar": np.uint8, "short": np.int16, "int16": np.int16,
               "float": np.float32, "double": np.float64}


def nifti_bytes(array: np.ndarray, spacing, origin) -> bytes:
    """A gzip'd single-file NIfTI-1 of a [z, y, x] array, its spacing and
    origin in x, y, z (LPS)."""
    code, bits = _NIFTI_TYPES[array.dtype]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [3, array.shape[2], array.shape[1], array.shape[0], 1, 1, 1, 1]
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<2h", hdr, 70, code, bits)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform 0, sform 1 (scanner)
    sx, sy, sz = spacing
    ox, oy, oz = origin
    struct.pack_into("<12f", hdr, 280, -sx, 0, 0, -ox, 0, -sy, 0, -oy,
                     0, 0, sz, oz)
    hdr[344:348] = b"n+1\0"
    payload = bytes(hdr) + b"\0" * 4 + np.ascontiguousarray(
        array, array.dtype.newbyteorder("<")).tobytes()
    return gzip.compress(payload, compresslevel=1)


def f32(values) -> tuple:
    """The values as the NIfTI header holds them (float32)."""
    return tuple(float(np.float32(v)) for v in values)


def read_nrrd(path: str) -> Dict:
    """array [z, y, x], spacing (norms of the space directions), direction
    columns and origin of an NRRD file with raw or gzip encoding."""
    with open(path, "rb") as fh:
        blob = fh.read()
    head, _, payload = blob.partition(b"\n\n")
    fields = {}
    for line in head.decode("ascii").splitlines()[1:]:
        if line.startswith("#") or ":" not in line:
            continue
        key, _, value = line.partition(":")
        fields[key.strip()] = value.lstrip("=").strip()
    sizes = [int(v) for v in fields["sizes"].split()]
    if fields.get("encoding", "raw") in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    dtype = np.dtype(_NRRD_TYPES[fields["type"]]).newbyteorder(
        "<" if fields.get("endian", "little") == "little" else ">")
    array = np.frombuffer(payload, dtype).reshape(tuple(reversed(sizes)))
    vectors = [tuple(float(x) for x in v.strip("()").split(","))
               for v in fields["space directions"].split()]
    spacing = tuple(float(np.linalg.norm(v)) for v in vectors)
    origin = tuple(float(x) for x in
                   fields["space origin"].strip("()").split(","))
    return {"array": array.astype(array.dtype.newbyteorder("=")),
            "spacing": spacing, "origin": origin,
            "direction": tuple(tuple(c / s for c in v)
                               for v, s in zip(vectors, spacing))}
