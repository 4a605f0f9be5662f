"""Model dispatcher — counterpart of ``cmrtpu/models/hybrids.py:get_model``.

Only ``MODEL_VARIANT: unet`` (the plain U-Net every template config uses) is
ported; the hybrid and (2+1)D variants raise."""

from __future__ import annotations

from typing import Dict

from cmrtpu_torch import config as C
from cmrtpu_torch.models.unet import UNet, build_model


def get_model(config: Dict, supervision: bool = False) -> UNet:
    """MODEL_VARIANT selects the model; 'unet' is the only one ported."""
    variant = str(C.get(config, "MODEL_VARIANT", "unet")).lower()
    if variant in ("unet", ""):
        return build_model(config, supervision=supervision)
    item = "4.4" if variant == "unet_2p1d" else "4.2"
    raise NotImplementedError(
        f"MODEL_VARIANT={variant!r} is not ported to cmrtpu_torch yet "
        f"(ROADMAP {item}); serve it with cmrtpu")
