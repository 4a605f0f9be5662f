"""Hand-written CUDA kernels: build, ``ctypes`` binding and wrappers.

Counterpart of ``cmrtpu/ops/pallas_kernels.py``. The one kernel on the
serving path is ``converge_labels_cuda`` (``csrc/cc_labels.cu``), which
replaces ``converge_labels_pallas``.

The library is compiled with ``nvcc`` for ``sm_90a`` from the package's own
sources into ``cmrtpu_torch/_build/`` at first use, and again whenever the
source is newer than the library. Nothing here runs at import: the CPU tests
import this module on hosts with no ``nvcc`` and no card. A failed build or
launch raises; there is no fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cc_labels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libcc_labels.so")

# opt-in dynamic shared memory one block may use on sm_90 (H100/H200)
SMEM_LIMIT = 232_448

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of cmrtpu_torch cannot be built")


def build() -> str:
    """Compile ``csrc/cc_labels.cu`` into ``_build/libcc_labels.so``.
    Returns ptxas's resource report (registers, shared memory, spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIBRARY)
                    or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
                build()
            lib = ctypes.CDLL(LIBRARY)
            lib.cc_labels_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.cc_labels_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def converge_labels_cuda(masks: torch.Tensor) -> torch.Tensor:
    """4-connected component labels of a stack of binary masks [N, H, W]
    (bool or uint8, contiguous, on a CUDA device).

    Returns int32 [N, H, W]: component id = min linear index of the
    component, background = 2**30 — the contract of
    ``cmrtpu.ops.pallas_kernels.converge_labels_pallas``, always run to the
    fixed point. One slice's labels must fit one block's shared memory
    (``SMEM_LIMIT``); larger slices raise ``ValueError``."""
    if masks.device.type != "cuda":
        raise ValueError(
            f"converge_labels_cuda takes a CUDA tensor, got {masks.device}; "
            "the plain version is "
            "cmrtpu_torch.ops.connected_components.label_components_2d")
    if masks.dim() != 3:
        raise ValueError(f"masks must be [N, H, W], got {tuple(masks.shape)}")
    if masks.dtype == torch.bool:
        masks = masks.view(torch.uint8)
    if masks.dtype != torch.uint8:
        raise TypeError(f"masks must be bool or uint8, got {masks.dtype}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    n, h, w = masks.shape
    smem = h * w * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"[{h}, {w}] int32 labels take {smem} B of shared memory; the "
            f"kernel keeps one slice per block and a block may hold at most "
            f"{SMEM_LIMIT} B")
    labels = torch.empty((n, h, w), dtype=torch.int32, device=masks.device)
    if n == 0:
        return labels
    lib = _library()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = lib.cc_labels_launch(masks.data_ptr(), labels.data_ptr(), n, h,
                                   w, stream)
    if err != 0:
        raise RuntimeError(f"cc_labels_launch failed: cudaError_t {err}")
    converge_labels_cuda.launches += 1
    return labels


converge_labels_cuda.launches = 0  # kernel launches since the last reset
