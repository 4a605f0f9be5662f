"""Inverse-preprocessing back into original image geometry (the port's
copy of ``cmrtpu/predict/postprocess.py``).

Parity with ``undo_generator_steps`` (ref: src/data/Postprocess.py:8-61):
1. compute the intermediate resampled size the generator produced,
2. centre pad/crop the prediction back to that size,
3. stamp the config spacing,
4. resample into the original image's spacing/size.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np

from cmrtpu_torch import config as C
from cmrtpu_torch.io import MedicalImage
from cmrtpu_torch.ops import resample as R
from cmrtpu_torch.pipeline import transforms as T


def undo_generator_steps(ndarray: np.ndarray, cfg: Dict,
                         interpolate: int = R.LINEAR,
                         orig: MedicalImage = None) -> MedicalImage:
    """[z, y, x] prediction -> MedicalImage in ``orig``'s geometry."""
    orig_size = orig.size          # (x, y, z)
    orig_spacing = orig.spacing

    # generator spacing in sitk order: (x, y) from cfg + original z spacing
    # (ref: Postprocess.py:41-44 builds (z, y, x) then reverses)
    cfg_spacing_np = np.array((orig_spacing[-1], *C.get(cfg, "SPACING")))
    cfg_spacing = list(reversed(cfg_spacing_np))   # -> (x, y, z)
    new_size = T.calc_resampled_size(orig_size, orig_spacing, cfg_spacing)
    new_size_np = list(reversed(new_size))         # numpy (z, y, x)

    ndarray = T.pad_and_crop(ndarray, new_size_np)
    intermediate = MedicalImage(array=ndarray, spacing=tuple(cfg_spacing),
                                origin=orig.origin[:ndarray.ndim],
                                direction=tuple(
                                    orig.direction_matrix[:ndarray.ndim,
                                                          :ndarray.ndim].flatten()))
    out = R.resample_image(intermediate, orig_size, orig_spacing, interpolate)
    return replace(out, origin=orig.origin, direction=orig.direction,
                   metadata=dict(orig.metadata))
