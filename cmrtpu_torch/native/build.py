"""Build + load the native cmrio shared library.

Compiled lazily with g++ (or clang++) on first use and cached as
``cmrtpu_torch/_build/libcmrio-<abi>.so`` (gitignored). Thread-safe; failures
degrade to ``native_available() == False`` so the pure-Python IO paths take
over: host I/O, bit-exact either way, not a device fallback.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cmrio.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD, "libcmrio-v2.so")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_failed = False


def _compile() -> bool:
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        return False
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-lz", "-o", tmp]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.SubprocessError, OSError) as exc:
        logging.warning("cmrio native build failed (%s); using python IO", exc)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, u8p, i32 = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32
    lib.cmr_inflate.restype = i64
    lib.cmr_inflate.argtypes = [u8p, i64, u8p, i64]
    lib.cmr_deflate_gzip.restype = i64
    lib.cmr_deflate_gzip.argtypes = [u8p, i64, u8p, i64, ctypes.c_int]
    lib.cmr_read_file.restype = i64
    lib.cmr_read_file.argtypes = [ctypes.c_char_p, u8p, i64,
                                  ctypes.POINTER(i64)]
    lib.cmr_inflate_batch.restype = None
    lib.cmr_inflate_batch.argtypes = [ctypes.POINTER(u8p),
                                      ctypes.POINTER(i64),
                                      ctypes.POINTER(u8p),
                                      ctypes.POINTER(i64),
                                      ctypes.POINTER(i64), i32, i32]
    lib.cmr_version.restype = i32
    lib.cmr_version.argtypes = []
    return lib


def get_library() -> "ctypes.CDLL | None":
    """The loaded cmrio library, building it on first call; None if native
    IO is unavailable in this environment."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if os.environ.get("CMRTPU_DISABLE_NATIVE"):
            _failed = True
            return None
        stale = (not os.path.exists(_LIB)
                 or os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
        if stale and not _compile() and not os.path.exists(_LIB):
            _failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB))
        except OSError as exc:
            logging.warning("cmrio load failed (%s); using python IO", exc)
            _failed = True
    return _lib


def native_available() -> bool:
    return get_library() is not None
