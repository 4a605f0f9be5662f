"""ctypes wrappers over libcmrio with pure-Python fallbacks.

These are the only entry points the rest of the framework uses; callers
never touch ctypes directly. Every function works identically (bit-exact
payloads) whether the native library is present or not.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import zlib
from typing import List, Optional, Sequence

import numpy as np

from cmrtpu_torch.native.build import get_library

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _as_u8p(buf) -> "ctypes._Pointer":
    return ctypes.cast(ctypes.addressof(ctypes.c_char.from_buffer(buf)), _u8p)


def _ro_u8p(data: bytes) -> "ctypes._Pointer":
    return ctypes.cast(ctypes.c_char_p(data), _u8p)


def _inflate_py(data: bytes) -> bytes:
    """Pure-Python fallback, multi-member-gzip aware (zlib.decompress with
    MAX_WBITS|32 would silently stop at the first member)."""
    if data[:2] == b"\x1f\x8b":
        return gzip.decompress(data)  # handles concatenated members
    return zlib.decompress(data, zlib.MAX_WBITS | 32)


def gzip_isize_hint(data: bytes) -> Optional[int]:
    """Uncompressed-size hint from the gzip ISIZE trailer (mod 2^32); None
    for non-gzip streams. Exact for single-member files < 4 GiB — avoids the
    grow-and-retry loop on high-compression-ratio payloads (masks)."""
    if len(data) >= 18 and data[:2] == b"\x1f\x8b":
        return int.from_bytes(data[-4:], "little") or None
    return None


def inflate(data: bytes, size_hint: Optional[int] = None) -> bytes:
    """Decompress a zlib/gzip stream (multi-member gzip supported)."""
    lib = get_library()
    if lib is None:
        return _inflate_py(data)
    if size_hint is None:
        size_hint = gzip_isize_hint(data)
    cap = max(size_hint or 0, 4 * len(data), 1 << 16)
    for _ in range(8):
        out = bytearray(cap)
        n = lib.cmr_inflate(_ro_u8p(data), len(data), _as_u8p(out), cap)
        if n >= 0:
            return bytes(out[:n])
        if n == -2:
            cap *= 4
            continue
        raise zlib.error("cmr_inflate failed")
    raise zlib.error("cmr_inflate: output larger than expected")


def deflate_gzip(data: bytes, level: int = 1) -> bytes:
    """Gzip-compress ``data`` (container format, readable by any gzip)."""
    lib = get_library()
    if lib is None:
        return gzip.compress(data, compresslevel=level)
    cap = len(data) + len(data) // 2 + 1024
    out = bytearray(cap)
    n = lib.cmr_deflate_gzip(_ro_u8p(data), len(data), _as_u8p(out), cap, level)
    if n == -2:  # incompressible payload; retry with worst-case bound
        cap = len(data) * 2 + 4096
        out = bytearray(cap)
        n = lib.cmr_deflate_gzip(_ro_u8p(data), len(data), _as_u8p(out), cap, level)
    if n < 0:
        raise zlib.error("cmr_deflate_gzip failed")
    return bytes(out[:n])


def read_file_bytes(path: str) -> bytes:
    """Whole-file read through the native core (falls back to open/read)."""
    lib = get_library()
    if lib is None:
        with open(path, "rb") as fh:
            return fh.read()
    size = os.path.getsize(path)
    out = bytearray(size)
    actual = ctypes.c_int64(0)
    n = lib.cmr_read_file(path.encode(), _as_u8p(out) if size else _u8p(),
                          size, ctypes.byref(actual))
    if n == -2:  # grew between stat and read
        out = bytearray(actual.value)
        n = lib.cmr_read_file(path.encode(), _as_u8p(out), actual.value,
                              ctypes.byref(actual))
    if n < 0:
        raise OSError(f"cmr_read_file failed for {path}")
    return bytes(out[:n])


def inflate_batch(blobs: Sequence[bytes],
                  size_hints: Optional[Sequence[int]] = None,
                  n_threads: int = 0) -> List[bytes]:
    """Decompress many streams on a native thread pool (no GIL in the loop).

    The host-parallel analogue of the reference generator's per-element
    ThreadPoolExecutor fan-out (ref: src/data/Generators.py:89-94).
    """
    lib = get_library()
    if lib is None:
        return [_inflate_py(b) for b in blobs]
    if len(blobs) == 0:
        return []
    if n_threads <= 0:
        n_threads = min(len(blobs), os.cpu_count() or 4)
    results: List[Optional[bytes]] = [None] * len(blobs)
    pending = list(range(len(blobs)))
    caps = {i: max((size_hints[i] if size_hints else 0)
                   or gzip_isize_hint(blobs[i]) or 0,
                   4 * len(blobs[i]), 1 << 16)
            for i in pending}
    for _ in range(8):
        n = len(pending)
        dsts = {i: bytearray(caps[i]) for i in pending}
        src_arr = (_u8p * n)(*[_ro_u8p(blobs[i]) for i in pending])
        srclen_arr = (ctypes.c_int64 * n)(*[len(blobs[i]) for i in pending])
        dst_arr = (_u8p * n)(*[_as_u8p(dsts[i]) for i in pending])
        cap_arr = (ctypes.c_int64 * n)(*[caps[i] for i in pending])
        out_arr = (ctypes.c_int64 * n)()
        lib.cmr_inflate_batch(src_arr, srclen_arr, dst_arr, cap_arr, out_arr,
                              n, n_threads)
        retry = []
        for pos, i in enumerate(pending):
            if out_arr[pos] >= 0:
                results[i] = bytes(dsts[i][:out_arr[pos]])
            elif out_arr[pos] == -2:  # grow and retry ONLY this entry
                caps[i] *= 4
                retry.append(i)
            else:
                raise zlib.error("cmr_inflate_batch failed")
        if not retry:
            return results  # type: ignore[return-value]
        pending = retry
    raise zlib.error("cmr_inflate_batch: output larger than expected")


def inflate_into(data: bytes, out: np.ndarray) -> int:
    """Decompress directly into a preallocated numpy buffer (zero copy-out).
    Returns bytes written."""
    lib = get_library()
    if lib is None:
        raw = _inflate_py(data)
        flat = out.reshape(-1).view(np.uint8)
        flat[:len(raw)] = np.frombuffer(raw, np.uint8)
        return len(raw)
    flat = out.reshape(-1).view(np.uint8)
    ptr = flat.ctypes.data_as(_u8p)
    n = lib.cmr_inflate(_ro_u8p(data), len(data), ptr, flat.nbytes)
    if n < 0:
        raise zlib.error("cmr_inflate_into failed")
    return int(n)
