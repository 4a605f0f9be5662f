"""Hand-written CUDA kernels: build, ``ctypes`` binding and wrappers.

Counterpart of ``cmrtpu/ops/pallas_kernels.py``, one kernel for each Pallas
kernel there:

  ``gaussian_blur_2d_cuda``  K1, ``csrc/gaussian_blur.cu``, replaces
                             ``gaussian_blur_2d_pallas`` (training targets)
  ``converge_labels_cuda``   K2, ``csrc/cc_labels.cu``, replaces
                             ``converge_labels_pallas`` (serving CC filter)

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one process
per source, all at once) and linked into one library in
``cmrtpu_torch/_build/`` at first use, and again whenever a source is newer
than the library. Nothing here runs at import: the CPU tests import this
module on hosts with no ``nvcc`` and no card. A failed build or launch
raises; there is no fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libcmrtpu_kernels.so")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC")

# opt-in dynamic shared memory one block may use on sm_90 (H100/H200)
SMEM_LIMIT = 232_448
# K1's output tile side and largest radius (csrc/gaussian_blur.cu kTile,
# kMaxRadius): the (32 + 2r)^2 window plus the 32 x (32 + 2r) scratch must
# fit SMEM_LIMIT
BLUR_TILE = 32
BLUR_MAX_RADIUS = 96
MAX_GRID_Z = 65_535

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of cmrtpu_torch cannot be built")


def _run(procs):
    """Wait for (cmd, Popen) pairs; raise on the first failure. Returns the
    compilers' stderr (ptxas's resource reports) joined."""
    reports = []
    for cmd, proc in procs:
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}{err}")
        reports.append(err)
    return "".join(reports)


def build() -> str:
    """Compile every ``csrc/*.cu`` in parallel and link them into
    ``_build/libcmrtpu_kernels.so``. Returns ptxas's resource report
    (registers, shared memory, spills) of every kernel."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objects, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR,
                           f"{os.path.basename(src)[:-3]}.{tag}.o")
        cmd = [nvcc, *_NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        objects.append(obj)
    try:
        report = _run(procs)
        tmp = f"{LIBRARY}.{tag}"
        link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", tmp, *objects]
        _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, LIBRARY)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.unlink(obj)
    return report


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIBRARY) or os.path.getmtime(LIBRARY)
                    < max(os.path.getmtime(s) for s in SOURCES)):
                build()
            lib = ctypes.CDLL(LIBRARY)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cc_labels_launch.argtypes = [ptr, ptr, i32, i32, i32, ptr]
            lib.cc_labels_launch.restype = i32
            lib.gaussian_blur_launch.argtypes = [
                ptr, ptr, i32, i32, i32, ctypes.POINTER(ctypes.c_float), i32,
                ptr]
            lib.gaussian_blur_launch.restype = i32
            _lib = lib
    return _lib


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


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
        err = lib.cc_labels_launch(masks.data_ptr(), labels.data_ptr(), n, h,
                                   w, _stream(masks.device))
    if err != 0:
        raise RuntimeError(f"cc_labels_launch failed: cudaError_t {err}")
    converge_labels_cuda.launches += 1
    return labels


converge_labels_cuda.launches = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=None)
def _blur_taps(sigma: float, truncate: float) -> np.ndarray:
    """gaussian_kernel1d's float32 taps, computed once per (sigma,
    truncate): the launch passes them by value."""
    from cmrtpu_torch.ops.gaussian import gaussian_kernel1d

    return np.ascontiguousarray(gaussian_kernel1d(sigma, truncate),
                                np.float32)


def blur_smem_bytes(radius: int) -> int:
    """Shared memory one K1 block needs at ``radius`` (mirrors
    ``gaussian_blur_launch`` in the source)."""
    span = BLUR_TILE + 2 * radius
    return (span * span + BLUR_TILE * span) * 4


def gaussian_blur_2d_cuda(x: torch.Tensor, sigma: float,
                          truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur of each [H, W] slice of a float32 stack [N, H, W]
    (contiguous, on a CUDA device), scipy parity: radius
    ``int(truncate * sigma + 0.5)``, normalised taps, 'reflect' border — the
    contract of ``cmrtpu.ops.pallas_kernels.gaussian_blur_2d_pallas``.
    A radius whose window does not fit one block's shared memory
    (``SMEM_LIMIT``) raises ``ValueError``."""
    if x.device.type != "cuda":
        raise ValueError(
            f"gaussian_blur_2d_cuda takes a CUDA tensor, got {x.device}; "
            "the plain version is cmrtpu_torch.ops.gaussian.gaussian_blur_2d")
    if x.dim() != 3:
        raise ValueError(f"x must be [N, H, W], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    taps = _blur_taps(float(sigma), float(truncate))
    radius = (taps.size - 1) // 2
    smem = blur_smem_bytes(radius)
    if radius > BLUR_MAX_RADIUS or smem > SMEM_LIMIT:
        raise ValueError(
            f"sigma {sigma} gives radius {radius}: its "
            f"{BLUR_TILE + 2 * radius}^2 window and scratch take {smem} B of "
            f"shared memory; a block may hold at most {SMEM_LIMIT} B "
            f"(radius <= {BLUR_MAX_RADIUS})")
    n, h, w = x.shape
    if n > MAX_GRID_Z:
        raise ValueError(f"{n} slices exceed the grid's z limit {MAX_GRID_Z}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.gaussian_blur_launch(
            x.data_ptr(), out.data_ptr(), n, h, w,
            taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), radius,
            _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gaussian_blur_launch failed: cudaError_t {err}")
    gaussian_blur_2d_cuda.launches += 1
    return out


gaussian_blur_2d_cuda.launches = 0  # kernel launches since the last reset
