"""Hand-written CUDA kernels: build, ``ctypes`` binding and wrappers.

Counterpart of ``cmrtpu/ops/pallas_kernels.py``, one kernel for each Pallas
kernel there, and one for an XLA loop of cmrtpu's:

  ``gaussian_blur_2d_cuda``  K1, ``csrc/gaussian_blur.cu``, replaces
                             ``gaussian_blur_2d_pallas`` (training targets)
  ``converge_labels_cuda``   K2, ``csrc/cc_labels.cu``, replaces
                             ``converge_labels_pallas`` (serving CC filter)
  ``converge_labels_3d_cuda`` ``csrc/cc_labels_3d.cu``, replaces the
                             while_loop of ``label_components_3d`` in
                             ``cmrtpu/ops/connected_components.py``
                             (CC_FILTER '3d')

Both CC kernels are tiled union-finds in three launches: a local pass in
shared memory (a ballot makes each row's runs trees, then one union per
contact of a run with a run of a neighbour row inside the tile), a pass
of unions in device memory across the tiles' faces only, and a flatten.
K2's tiles are 32 x 32 pixels of a slice, the 3D kernel's 32 columns x 8
rows x up to 16 slices of a volume (``cc3d_geometry``), joined under
26-connectivity. Both move 1 B in and 4 B out per pixel or voxel, so
memory bounds them; on the serving path's sparse masks each pass is near
the floor of a launch, on dense ones the shared-memory unions take most.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one process
per source, all at once) and linked into one library in
``cmrtpu_torch/_build/`` at first use, and again whenever a source or a
header (``csrc/*.cuh``) is newer than the library. Nothing here runs at import: the CPU tests import this
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
from typing import Optional, Tuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
# headers the sources include: a newer one rebuilds the library too
HEADERS = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh"))))
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libcmrtpu_kernels.so")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC")

# opt-in dynamic shared memory one block may use on sm_90 (H100/H200)
SMEM_LIMIT = 232_448
# K1's block is a strip of output rows by a chunk of output columns
# (csrc/gaussian_blur.cu): the strip's rows plus their halo, the scratch of
# the pass along H and a column table must fit SMEM_LIMIT. The strip height
# is the one measured fastest at the training path's [32, 224, 224]
# (cmrtpu_torch/tools/k1_sweep.py, PERF.md); the smallest block (4 rows by
# 32 columns) bounds the radius.
BLUR_STRIP_ROWS = 28
BLUR_MIN_STRIP, BLUR_MIN_CHUNK = 4, 32
BLUR_MAX_RADIUS = 108
# a grid's y and z extents
MAX_GRID_YZ = 65_535
# K2's tile side (csrc/cc_labels.cu kTile)
CC_TILE = 32
# the 3D kernel's tile (csrc/cc_labels_3d.cu): CC_TILE columns x CC3D_ROWS
# rows x up to CC3D_MAX_DEPTH slices, its parents, row bits and a queue of
# CC3D_QUEUE union pairs in static shared memory, which a block may hold up
# to STATIC_SMEM_LIMIT of
CC3D_ROWS = 8
CC3D_MAX_DEPTH = 16
CC3D_QUEUE = 4096
STATIC_SMEM_LIMIT = 49_152

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
                    < max(os.path.getmtime(s) for s in SOURCES + HEADERS)):
                build()
            lib = ctypes.CDLL(LIBRARY)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cc_labels_launch.argtypes = [ptr, ptr, i32, i32, i32, ptr]
            lib.cc_labels_launch.restype = i32
            lib.cc_labels_3d_launch.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                                i32, ptr]
            lib.cc_labels_3d_launch.restype = i32
            lib.gaussian_blur_launch.argtypes = [
                ptr, ptr, i32, i32, i32, ctypes.POINTER(ctypes.c_float), i32,
                i32, i32, ptr]
            lib.gaussian_blur_launch.restype = i32
            _lib = lib
    return _lib


def _launch(launcher, device: torch.device, *args) -> None:
    """Call a C launcher with ``args`` and the current stream of
    ``device``, which is made the current device for the call; raise on a
    CUDA error. The raw-stream lookup is the one torch's own generated
    kernels use: a launch's host time is of the order of a kernel's."""
    index = device.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            _launch(launcher, device, *args)
        return
    err = launcher(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{launcher.__name__} failed: cudaError_t {err}")


def _mask_bytes(masks: torch.Tensor, name: str, layout: str,
                plain: str) -> torch.Tensor:
    """``masks`` as the uint8 view a CC kernel reads, after the checks: a
    contiguous bool or uint8 CUDA tensor of ``layout``'s axes."""
    if masks.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor, got {masks.device}; "
                         "the plain version is cmrtpu_torch.ops."
                         f"connected_components.{plain}")
    if masks.dim() != len(layout.split(", ")):
        raise ValueError(f"masks must be [{layout}], got "
                         f"{tuple(masks.shape)}")
    if masks.dtype == torch.bool:
        masks = masks.view(torch.uint8)
    if masks.dtype != torch.uint8:
        raise TypeError(f"masks must be bool or uint8, got {masks.dtype}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    return masks


def converge_labels_cuda(masks: torch.Tensor) -> torch.Tensor:
    """4-connected component labels of a stack of binary masks [N, H, W]
    (bool or uint8, contiguous, on a CUDA device).

    Returns int32 [N, H, W]: component id = min linear index of the
    component, background = 2**30 — the contract of
    ``cmrtpu.ops.pallas_kernels.converge_labels_pallas``, always run to the
    fixed point. Any slice size whose indices stay below the sentinel
    (H * W < 2**30) is taken; one call is one launch of the union-find's
    three passes."""
    masks = _mask_bytes(masks, "converge_labels_cuda", "N, H, W",
                        "label_components_2d")
    n, h, w = masks.shape
    if h * w >= 2 ** 30:
        raise ValueError(f"[{h}, {w}] slices have indices >= 2**30, the "
                         "background sentinel")
    if -(-h // CC_TILE) > MAX_GRID_YZ:
        raise ValueError(f"{h} rows exceed the grid's y limit "
                         f"({MAX_GRID_YZ} tiles of {CC_TILE})")
    labels = torch.empty((n, h, w), dtype=torch.int32, device=masks.device)
    if labels.numel() == 0:
        return labels
    _launch(_library().cc_labels_launch, masks.device, masks.data_ptr(),
            labels.data_ptr(), n, h, w)
    converge_labels_cuda.launches += 1
    return labels


converge_labels_cuda.launches = 0  # kernel launches since the last reset


def cc3d_smem_bytes() -> int:
    """Static shared memory of one block of the 3D kernel's local pass
    (mirrors ``tile``, ``row_bits``, ``queue`` and ``queued`` in the
    source): an int32 parent per voxel and a 32-bit mask per row of the
    deepest tile, the queue of union pairs and its count."""
    return 4 * (CC3D_MAX_DEPTH * CC3D_ROWS * (CC_TILE + 1) + CC3D_QUEUE + 1)


def cc3d_geometry(z: int, h: int, w: int) -> Tuple[int, Tuple[int, int, int]]:
    """(tile depth, tiles along x, y and z) of the 3D kernel on [Z, H, W]
    volumes: the fewest tiles of at most ``CC3D_MAX_DEPTH`` slices along z,
    of the least depth that covers the slices with that many, so fewer
    slice slots than tiles lie past the volume and a volume of 1-16 slices
    is one tile deep. The local pass's grid is (tiles, volumes)."""
    depth = -(-z // -(-z // CC3D_MAX_DEPTH))
    return depth, (-(-w // CC_TILE), -(-h // CC3D_ROWS), -(-z // depth))


def converge_labels_3d_cuda(masks: torch.Tensor) -> torch.Tensor:
    """26-connected component labels of a stack of binary volumes
    [N, Z, H, W] (bool or uint8, contiguous, on a CUDA device), each volume
    labelled on its own.

    Returns int32 [N, Z, H, W]: component id = min volume-linear index
    ``z * H * W + y * W + x`` of the component, background = 2**30 — the
    contract of ``cmrtpu.ops.connected_components.label_components_3d``.
    Volumes whose indices stay below the sentinel (Z * H * W < 2**30) are
    taken; one call is one launch of the union-find's three passes, for
    the whole stack."""
    masks = _mask_bytes(masks, "converge_labels_3d_cuda", "N, Z, H, W",
                        "label_components_3d")
    n, z, h, w = masks.shape
    if z * h * w >= 2 ** 30:
        raise ValueError(f"[{z}, {h}, {w}] volumes have indices >= 2**30, "
                         "the background sentinel")
    labels = torch.empty((n, z, h, w), dtype=torch.int32,
                         device=masks.device)
    if labels.numel() == 0:
        return labels
    depth, _ = cc3d_geometry(z, h, w)
    _launch(_library().cc_labels_3d_launch, masks.device, masks.data_ptr(),
            labels.data_ptr(), n, z, h, w, depth)
    converge_labels_3d_cuda.launches += 1
    return labels


converge_labels_3d_cuda.launches = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=None)
def _blur_taps(sigma: float, truncate: float):
    """gaussian_kernel1d's float32 taps and a ctypes pointer to them,
    made once per (sigma, truncate): the launch copies them into the
    kernel's parameters."""
    from cmrtpu_torch.ops.gaussian import gaussian_kernel1d

    taps = np.ascontiguousarray(gaussian_kernel1d(sigma, truncate),
                                np.float32)
    return taps, taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _round4(v: int) -> int:
    return (v + 3) & ~3


def blur_smem_bytes(radius: int, strip_rows: int = BLUR_MIN_STRIP,
                    chunk_cols: int = BLUR_MIN_CHUNK) -> int:
    """Shared memory of one K1 block of ``strip_rows`` x ``chunk_cols``
    outputs at ``radius`` (mirrors ``smem_words`` in the source): the
    strip's rows with their 2r halo rows, the scratch of the pass along H
    and the table of window columns. The defaults are the smallest block."""
    span = chunk_cols + 2 * radius
    return 4 * ((strip_rows + 2 * radius) * (_round4(span) + 8)
                + strip_rows * _round4(span + 4) + span)


@functools.lru_cache(maxsize=64)
def blur_geometry(h: int, w: int, radius: int) -> Tuple[int, int]:
    """(strip rows, chunk columns) of K1's blocks on [H, W] slices:
    ``BLUR_STRIP_ROWS`` rows of the full width where that fits one block's
    shared memory; otherwise narrower chunks (down to 64 columns), then
    lower strips, then 32 columns."""
    if radius > BLUR_MAX_RADIUS:
        raise ValueError(
            f"radius {radius}: even a {BLUR_MIN_STRIP} x {BLUR_MIN_CHUNK} "
            f"block takes {blur_smem_bytes(radius)} B of shared memory; a "
            f"block may hold at most {SMEM_LIMIT} B (radius <= "
            f"{BLUR_MAX_RADIUS})")
    strip, chunk = min(BLUR_STRIP_ROWS, _round4(h)), _round4(w)
    while blur_smem_bytes(radius, strip, chunk) > SMEM_LIMIT:
        if chunk > 2 * BLUR_MIN_CHUNK:
            chunk = _round4(-(-chunk // 2))
        elif strip > BLUR_MIN_STRIP:
            strip = _round4(strip // 2)
        else:
            chunk = BLUR_MIN_CHUNK
    return strip, chunk


def _launch_blur(x: torch.Tensor, out: torch.Tensor, taps, strip: int,
                 chunk: int) -> None:
    """One launch of K1 on ``x`` into ``out`` with the given block shape
    and ``_blur_taps``; counts nothing (``gaussian_blur_2d_cuda`` does)."""
    (host_taps, pointer), (n, h, w) = taps, x.shape
    if -(-h // strip) > MAX_GRID_YZ or -(-w // chunk) > MAX_GRID_YZ:
        raise ValueError(f"[{h}, {w}] slices need more than {MAX_GRID_YZ} "
                         f"blocks of {strip} x {chunk} along a side")
    _launch(_library().gaussian_blur_launch, x.device, x.data_ptr(),
            out.data_ptr(), n, h, w, pointer, (host_taps.size - 1) // 2, strip,
            chunk)


def gaussian_blur_2d_cuda(x: torch.Tensor, sigma: float,
                          truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur of each [H, W] slice of a float32 stack [N, H, W]
    (contiguous, on a CUDA device), scipy parity: radius
    ``int(truncate * sigma + 0.5)``, normalised taps, 'reflect' border — the
    contract of ``cmrtpu.ops.pallas_kernels.gaussian_blur_2d_pallas``.
    A radius above ``BLUR_MAX_RADIUS``, whose smallest block does not fit
    one block's shared memory (``SMEM_LIMIT``), raises ``ValueError``."""
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
    _, h, w = x.shape
    strip, chunk = blur_geometry(h, w, (taps[0].size - 1) // 2)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _launch_blur(x, out, taps, strip, chunk)
    gaussian_blur_2d_cuda.launches += 1
    return out


gaussian_blur_2d_cuda.launches = 0  # kernel launches since the last reset
