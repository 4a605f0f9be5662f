"""MedicalImage: numpy array + physical geometry (spacing/origin/direction).

A lightweight stand-in for ``sitk.Image`` carrying exactly the structural
information the reference pipeline uses: voxel spacing, origin and direction in
x,y,z (sitk) axis order, string metadata, and the pixel array in numpy
[($t$,) $z$, $y$, $x$] order. The cross-dimension metadata copy rules mirror
``copy_meta_and_save`` (ref: src/data/Dataset.py:163-250): same-dim copies
everything, smaller-dim slices spacing/origin and the top-left direction
sub-matrix, bigger-dim pads spacing/origin with 1.0.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Sequence, Tuple

import numpy as np


def _identity_direction(dim: int) -> Tuple[float, ...]:
    return tuple(np.eye(dim).flatten())


@dataclass
class MedicalImage:
    array: np.ndarray                       # [(t,) z, y, x] index order
    spacing: Tuple[float, ...] = None       # (x, y, z[, t]) — sitk order
    origin: Tuple[float, ...] = None        # (x, y, z[, t])
    direction: Tuple[float, ...] = None     # row-major dim x dim, sitk order
    metadata: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        dim = self.array.ndim
        if self.spacing is None:
            self.spacing = (1.0,) * dim
        if self.origin is None:
            self.origin = (0.0,) * dim
        if self.direction is None:
            self.direction = _identity_direction(dim)
        self.spacing = tuple(float(s) for s in self.spacing)
        self.origin = tuple(float(o) for o in self.origin)
        self.direction = tuple(float(d) for d in self.direction)
        assert len(self.spacing) == dim and len(self.origin) == dim, (
            f"geometry/array dim mismatch: {len(self.spacing)} vs {dim}")

    # -- sitk-parity accessors -------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.array.ndim

    @property
    def size(self) -> Tuple[int, ...]:
        """(x, y, z[, t]) — reversed numpy shape, sitk GetSize parity."""
        return tuple(reversed(self.array.shape))

    @property
    def direction_matrix(self) -> np.ndarray:
        return np.asarray(self.direction, dtype=np.float64).reshape(self.ndim, self.ndim)

    @property
    def inplane_spacing(self) -> float:
        """In-plane (x) spacing — ref: evaluate_cv.py:703 uses GetSpacing()[0]."""
        return self.spacing[0]

    def astype(self, dtype) -> "MedicalImage":
        return replace(self, array=self.array.astype(dtype))

    def with_array(self, array: np.ndarray) -> "MedicalImage":
        """New image from ``array``, copying geometry with cross-dim rules."""
        new = MedicalImage(array=np.asarray(array))
        return copy_meta(new, self)

    # physical <-> index transforms (identity-direction fast path is the common
    # case for ACDC; full direction handling kept for generality)
    def index_to_physical(self, idx_xyz: Sequence[float]) -> np.ndarray:
        idx = np.asarray(idx_xyz, dtype=np.float64)
        return np.asarray(self.origin) + self.direction_matrix @ (idx * np.asarray(self.spacing))

    def physical_to_index(self, pt_xyz: Sequence[float]) -> np.ndarray:
        pt = np.asarray(pt_xyz, dtype=np.float64)
        rel = np.linalg.solve(self.direction_matrix, pt - np.asarray(self.origin))
        return rel / np.asarray(self.spacing)


def copy_meta(new_image: MedicalImage, reference: MedicalImage | None,
              copy_direction: bool = True) -> MedicalImage:
    """Copy metadata + structural info across (possibly different) dimensions.

    Mirrors the dimension cases of ``copy_meta_and_save``
    (ref: src/data/Dataset.py:163-250), including its ``copy_direction``
    switch: when False the new image keeps the identity direction
    (ref: Dataset.py:211-214).
    """
    if reference is None:
        return new_image
    new_dim, ref_dim = new_image.ndim, reference.ndim
    meta = dict(reference.metadata)

    if ref_dim == new_dim:
        direction = (reference.direction if copy_direction
                     else _identity_direction(new_dim))
        return replace(new_image, spacing=reference.spacing, origin=reference.origin,
                       direction=direction, metadata=meta)
    if ref_dim > new_dim:  # e.g. 3D reference -> 2D slice
        direction = (tuple(
            reference.direction_matrix[:new_dim, :new_dim].flatten())
            if copy_direction else _identity_direction(new_dim))
        return replace(new_image,
                       spacing=reference.spacing[:new_dim],
                       origin=reference.origin[:new_dim],
                       direction=direction, metadata=meta)
    # smaller reference -> bigger image: spacing pads with 1.0, origin with 0.0
    pad = new_dim - ref_dim
    return replace(new_image,
                   spacing=(*reference.spacing, *((1.0,) * pad)),
                   origin=(*reference.origin, *((0.0,) * pad)),
                   direction=_identity_direction(new_dim), metadata=meta)
