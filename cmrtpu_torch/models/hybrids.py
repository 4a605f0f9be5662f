"""The 2D-in-3D hybrid U-Nets and the model dispatcher — counterpart of
``cmrtpu/models/hybrids.py``.

Each hybrid takes a [B, Z, H, W, C] volume and folds z into the batch for
its 2D trunk: one 2D forward over B * Z slices, whose train-mode BatchNorm
statistics therefore run over every slice of the batch, as flax's do.

  * ``SliceDistributed2D`` ('wrapper'): the shared 2D U-Net over every
    slice, restacked.
  * ``Stacked2D3D`` ('followed', 'concat'): the 2D net's sigmoid
    probabilities (with the input volume concatenated for 'concat') feed
    a 3D U-Net, then ``head_3d``, a 1x1x1 f32 conv, soft cap and softmax.
  * ``Avg2D3D`` ('avg', 'avg_plain'): softmax of ``head_2d`` on the 2D
    net's probabilities averaged with softmax of ``head_3d`` on a 3D
    U-Net's; 'avg' adds ``head_avg`` with its softmax.

The trunks keep their own sigmoid ``head``. Submodules carry the flax names
(``unet_2d``, ``unet_3d``, ``head_2d``, ``head_3d``, ``head_avg``), so a
``state_dict`` key is the flax path with ``/`` -> ``.`` and the weights
bridge carries them unchanged. ``get_model`` maps MODEL_VARIANT to a
model: 'unet' (default), 'unet_2p1d' (the (2+1)D U-Net), 'swin_unet'
(``swin_unet.py``) or a hybrid.
REMAT, BN_BF16 and WEIGHT_STANDARDISATION reach both trunks through the
configs they are built from.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cmrtpu_torch import config as C
from cmrtpu_torch.models.swin_unet import build_swin_unet
from cmrtpu_torch.models.unet import (UNet, apply_softcap, build_model,
                                      he_normal_)

HYBRIDS = ("wrapper", "followed", "concat", "avg", "avg_plain")


def _as_2d_config(config: Dict) -> Dict:
    """The 2D trunk's config: DIM without its z entry, and F_SIZE and
    M_POOL without theirs where they carry one (rank == len(DIM))."""
    cfg = dict(config)
    dim = list(C.get(config, "DIM"))
    cfg["DIM"] = dim[1:]

    def strip(key, default3):
        value = list(C.get(config, key) or default3)
        return value[1:] if len(value) >= len(dim) else value

    cfg["F_SIZE"] = strip("F_SIZE", [3, 3, 3])
    cfg["M_POOL"] = strip("M_POOL", [1, 2, 2])
    return cfg


def _head(conv: nn.Conv3d, x: torch.Tensor, softcap) -> torch.Tensor:
    """A 1x1x1 conv of channels-last [B, Z, H, W, C] in the conv's dtype
    (float32, as flax's f32 head), soft cap, softmax over the channels.
    The input is made contiguous: on a strided one (a trunk's channels-last
    view) the CPU's matmul rounds differently for a Parameter and for a
    plain tensor of the same values, so ``Trainer.predict`` through
    ``functional_call`` would differ from the restored model by an ulp."""
    logits = torch.nn.functional.linear(
        x.to(conv.weight.dtype).contiguous(), conv.weight.flatten(1),
        conv.bias)
    return torch.softmax(apply_softcap(logits, softcap), dim=-1)


class _Hybrid(nn.Module):
    """The 2D trunk's slice-wise forward shared by the hybrids, and their
    initialisation."""

    def __init__(self, unet_2d: UNet, freeze_2d: bool = False):
        super().__init__()
        self.unet_2d = unet_2d
        self.freeze_2d = freeze_2d

    def train(self, mode: bool = True):
        """A frozen 2D trunk stays in eval mode: running averages, no
        dropout."""
        super().train(mode)
        if self.freeze_2d:
            self.unet_2d.eval()
        return self

    def _slice_forward(self, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """[B, Z, H, W, C] -> [B, Z, H, W, classes]: z folded into the
        batch, one 2D forward; a frozen trunk's output carries no
        gradient."""
        b, z, h, w, c = x.shape
        flat = x.reshape(b * z, h, w, c)
        if self.freeze_2d:
            with torch.no_grad():
                out = self.unet_2d(flat)
        else:
            out = self.unet_2d(flat, generator=generator)
        return out.reshape(b, z, h, w, out.shape[-1])

    def reset_parameters(self, generator: torch.Generator) -> "_Hybrid":
        """The trunks' initialisers, then he_normal heads with zero biases,
        all from ``generator``."""
        for child in self.children():
            if isinstance(child, UNet):
                child.reset_parameters(generator)
            elif isinstance(child, nn.Conv3d):
                he_normal_(child.weight, generator)
                with torch.no_grad():
                    child.bias.zero_()
        return self


class SliceDistributed2D(_Hybrid):
    """A shared 2D U-Net over the z axis (MODEL_VARIANT 'wrapper')."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._slice_forward(x, generator)


class Stacked2D3D(_Hybrid):
    """2D-per-slice probabilities (with the input for ``concat_input``) ->
    3D U-Net -> ``head_3d`` softmax ('followed', 'concat')."""

    def __init__(self, unet_2d: UNet, unet_3d: UNet, mask_classes: int = 4,
                 concat_input: bool = False, freeze_2d: bool = False,
                 logit_softcap=None):
        super().__init__(unet_2d, freeze_2d)
        self.unet_3d = unet_3d
        self.mask_classes = mask_classes
        self.concat_input = concat_input
        self.logit_softcap = logit_softcap
        self.head_3d = nn.Conv3d(mask_classes, mask_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out2d = self._slice_forward(x, generator)
        feed = torch.cat([out2d, x.to(out2d.dtype)], dim=-1) \
            if self.concat_input else out2d
        out3d = self.unet_3d(feed, generator=generator)
        return _head(self.head_3d, out3d, self.logit_softcap)


class Avg2D3D(_Hybrid):
    """The mean of the slice-wise 2D softmax volume and a 3D U-Net's softmax
    volume; ``final_conv`` ('avg') adds ``head_avg`` and its softmax,
    without it ('avg_plain') the mean is the output."""

    def __init__(self, unet_2d: UNet, unet_3d: UNet, mask_classes: int = 4,
                 freeze_2d: bool = False, final_conv: bool = True,
                 logit_softcap=None):
        super().__init__(unet_2d, freeze_2d)
        self.unet_3d = unet_3d
        self.mask_classes = mask_classes
        self.final_conv = final_conv
        self.logit_softcap = logit_softcap
        self.head_2d = nn.Conv3d(mask_classes, mask_classes, 1)
        self.head_3d = nn.Conv3d(mask_classes, mask_classes, 1)
        if final_conv:
            self.head_avg = nn.Conv3d(mask_classes, mask_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        prob2d = _head(self.head_2d, self._slice_forward(x, generator),
                       self.logit_softcap)
        prob3d = _head(self.head_3d, self.unet_3d(x, generator=generator),
                       self.logit_softcap)
        avg = (prob2d + prob3d) * 0.5
        if not self.final_conv:
            return avg
        return _head(self.head_avg, avg, self.logit_softcap)


def build_hybrid_model(config: Dict, variant: str = "avg",
                       supervision: bool = False) -> _Hybrid:
    """A hybrid of ``variant`` ('wrapper' | 'followed' | 'concat' | 'avg' |
    'avg_plain'); the 2D trunk's config strips the z entry of the geometry
    keys, the 3D trunk of 'followed' / 'concat' takes MASK_CLASSES (+1)
    input channels. A HEADS config raises: the hybrids have one output."""
    cfg = C.normalise_config(config)
    if variant not in HYBRIDS:
        raise ValueError(f"unknown hybrid variant: {variant}")
    if C.get(cfg, "HEADS", ()):
        # cmrtpu fails here with an AttributeError from its 2D trunk's
        # dict of head outputs (ROADMAP Queue 3)
        raise ValueError(f"MODEL_VARIANT={variant!r} with HEADS: a hybrid "
                         "has one output volume, not a dict of heads")
    mask_classes = C.get(cfg, "MASK_CLASSES")
    softcap = C.get(cfg, "LOGIT_SOFTCAP", None)
    unet_2d = build_model(_as_2d_config(cfg), supervision=supervision)
    if variant == "wrapper":
        return SliceDistributed2D(unet_2d)
    if variant in ("followed", "concat"):
        concat = variant == "concat"
        cfg3d = dict(cfg, IMG_CHANNELS=mask_classes + int(concat))
        return Stacked2D3D(unet_2d, build_model(cfg3d, supervision=supervision),
                           mask_classes=mask_classes, concat_input=concat,
                           logit_softcap=softcap)
    return Avg2D3D(unet_2d, build_model(cfg, supervision=supervision),
                   mask_classes=mask_classes,
                   final_conv=variant == "avg", logit_softcap=softcap)


def get_model(config: Dict, supervision: bool = False) -> nn.Module:
    """MODEL_VARIANT selects the plain U-Net ('unet', the default), the
    (2+1)D U-Net ('unet_2p1d'), the Swin-Unet ('swin_unet') or a
    hybrid."""
    variant = str(C.get(config, "MODEL_VARIANT", "unet")).lower()
    if variant in ("unet", ""):
        return build_model(config, supervision=supervision)
    if C.get(config, "QUANT_INT8", False) and variant != "unet_2p1d":
        # cmrtpu's quantize_model cannot calibrate a hybrid (no quant_mode,
        # cmrtpu/predict/quantize.py:50), so no hybrid twin exists
        raise ValueError(f"MODEL_VARIANT={variant!r} has no int8 twin: int8 "
                         "PTQ covers the UNet family (plain MODEL_VARIANT)")
    if variant == "unet_2p1d":
        return build_model(config, supervision=supervision, factorized=True)
    if variant == "swin_unet":
        if supervision:
            raise ValueError("MODEL_VARIANT='swin_unet' has no "
                             "deep-supervision branch")
        return build_swin_unet(config)
    return build_hybrid_model(config, variant=variant,
                              supervision=supervision)
