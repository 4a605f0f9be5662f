"""Loss and training metrics in torch — counterpart of
``cmrtpu/train/losses.py`` (parity with src/models/Loss_and_metrics.py).

Channels-last tensors [..., C], computed in float32 whatever the model's
compute dtype. Conventions kept from the reference:
  * soft dice with smooth=1 over the fully flattened tensors;
  * per-channel dice metrics index from the back;
  * BceDiceLoss = BCE - Dice, with keras's binary_crossentropy: clip to
    [1e-7, 1-1e-7] and eps added again inside each log.
Only the single-head losses of the main path are ported; other names raise.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

_KERAS_EPS = 1e-7
SMOOTH = 1.0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for a float64 reference evaluation."""
    return t if t.dtype == torch.float64 else t.float()


def dice_coef(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Soft dice, smooth=1, flattened (ref: Loss_and_metrics.py:165-171)."""
    yt = _wide(y_true.reshape(-1))
    yp = _wide(y_pred.reshape(-1))
    intersection = torch.sum(yt * yp)
    return (2.0 * intersection + SMOOTH) / (torch.sum(yt) + torch.sum(yp)
                                            + SMOOTH)


def dice_coef_channel(y_true, y_pred, channel: int) -> torch.Tensor:
    """Dice on one channel, negative indices from the back (ref: :129-152);
    NaN when the channel is absent in this config."""
    n = y_pred.shape[-1]
    if channel < 0 and -channel > n:
        return torch.tensor(float("nan"), device=y_pred.device)
    return dice_coef(y_true[..., channel], y_pred[..., channel])


def dice_coef_labels(y_true, y_pred) -> torch.Tensor:
    """Dice over the (up to 3) foreground channels from the back."""
    return dice_coef(y_true[..., -3:], y_pred[..., -3:])


def binary_crossentropy(y_true, y_pred) -> torch.Tensor:
    """keras binary_crossentropy in float32: elementwise
    ``-(y log(p+eps) + (1-y) log(1-p+eps))`` on p clipped to [eps, 1-eps],
    mean over the last (channel) axis."""
    p = torch.clamp(_wide(y_pred), _KERAS_EPS, 1.0 - _KERAS_EPS)
    yt = _wide(y_true)
    bce = -(yt * torch.log(p + _KERAS_EPS)
            + (1.0 - yt) * torch.log(1.0 - p + _KERAS_EPS))
    return torch.mean(bce, dim=-1)


def bce_dice_loss(y_true, y_pred, w_bce: float = 1.0,
                  w_dice: float = 1.0) -> torch.Tensor:
    """BceDiceLoss (ref: Loss_and_metrics.py:208-226): scalar
    mean(BCE)*w_bce - dice*w_dice, background sliced off for 4-channel
    heads."""
    if y_pred.shape[-1] == 4:
        y_pred = y_pred[..., -3:]
        y_true = y_true[..., -3:]
    return (torch.mean(binary_crossentropy(y_true, y_pred)) * w_bce
            - dice_coef(y_true, y_pred) * w_dice)


def mse_loss(y_true, y_pred) -> torch.Tensor:
    return torch.mean((_wide(y_true) - _wide(y_pred)) ** 2)


def get_loss(config: Dict) -> Callable:
    """Loss by name (accepts 'BcdDiceLoss' [sic] and 'BceDiceLoss',
    ref: src/models/train_model.py:178-184) and 'mse'."""
    if config.get("HEADS"):
        raise NotImplementedError(
            "the multi-head loss (HEADS) is not ported to cmrtpu_torch yet "
            "(ROADMAP 3.4)")
    name = str(config.get("LOSS_FUNCTION", "BceDiceLoss"))
    if "DiceLoss" in name or name == "bce_dice_loss":
        return bce_dice_loss
    if name.lower() in ("mse", "meansquarederror"):
        return mse_loss
    # cmrtpu falls back to BceDiceLoss for any other name; the port says so
    raise NotImplementedError(
        f"LOSS_FUNCTION={name!r} is not ported to cmrtpu_torch yet (ROADMAP "
        "3.10); the port trains with BceDiceLoss or mse")


def default_metrics(mask_classes: int) -> Dict[str, Callable]:
    """Per-channel dice metrics of the reference's train metrics
    (ref: src/models/train_model.py:54-59) with corrected indexing."""
    metrics = {"dice_coef_labels": dice_coef_labels}
    names = ["dice_coef_lv", "dice_coef_myo", "dice_coef_rv"]  # ch -1, -2, -3
    for i, name in enumerate(names):
        ch = -(i + 1)
        if mask_classes >= -ch:
            metrics[name] = lambda yt, yp, c=ch: dice_coef_channel(yt, yp, c)
    return metrics
