"""Loss and training metrics in torch — counterpart of
``cmrtpu/train/losses.py`` (parity with src/models/Loss_and_metrics.py).

Channels-last tensors [..., C], computed in float32 whatever the model's
compute dtype. Conventions kept from the reference:
  * soft dice with smooth=1 over the fully flattened tensors;
  * per-channel dice metrics index from the back;
  * BceDiceLoss = BCE - Dice, with keras's binary_crossentropy: clip to
    [1e-7, 1-1e-7] and eps added again inside each log;
  * a HEADS model's loss sums BCE+Dice over its sigmoid heads and CCE+Dice
    over its softmax heads, the targets concatenated in HEADS order.
Other loss names raise (ROADMAP 3.10). ``dice_numpy`` is the hard dice of
the evaluation, on numpy masks.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
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


def dice_numpy(y_true, y_pred, empty_score: float = 1.0) -> float:
    """Hard dice on numpy bool masks (ref: Loss_and_metrics.py:183-206)."""
    im1 = np.asarray(y_true).astype(bool)
    im2 = np.asarray(y_pred).astype(bool)
    if im1.shape != im2.shape:
        raise ValueError("Shape mismatch: im1 and im2 must have the same shape.")
    im_sum = im1.sum() + im2.sum()
    if im_sum == 0:
        return empty_score
    return 2.0 * np.logical_and(im1, im2).sum() / im_sum


def categorical_crossentropy(y_true, y_pred) -> torch.Tensor:
    """CCE over softmax probabilities (exclusive-class softmax heads):
    mean over the pixels of -sum_c y log(clip(p, 1e-7, 1))."""
    yp = torch.clamp(_wide(y_pred), _KERAS_EPS, 1.0)
    return -torch.mean(torch.sum(_wide(y_true) * torch.log(yp), dim=-1))


def cce_dice_loss(y_true, y_pred, w_cce: float = 1.0,
                  w_dice: float = 1.0) -> torch.Tensor:
    return w_cce * categorical_crossentropy(y_true, y_pred) \
        - w_dice * dice_coef(y_true, y_pred)


def multi_head_loss(heads: Sequence) -> Callable:
    """Loss of a HEADS model: ``y_true`` holds the heads' target channels
    concatenated in HEADS order, ``preds`` maps each head's name to its
    probabilities. Per head BCE+Dice (sigmoid) or CCE+Dice (softmax),
    summed."""
    heads = [tuple(h) for h in heads]

    def loss(y_true, preds):
        total = 0.0
        offset = 0
        for name, channels, act in heads:
            channels = int(channels)
            y_head = y_true[..., offset:offset + channels]
            head_loss = cce_dice_loss if act == "softmax" else bce_dice_loss
            total = total + head_loss(y_head, preds[name])
            offset += channels
        return total

    return loss


def concat_heads(heads: Sequence) -> Callable:
    """preds dict -> channel-concatenated tensor in HEADS order, so the
    tensor metrics run on multi-head outputs."""
    names = [h[0] for h in heads]

    def concat(preds):
        return torch.cat([preds[n] for n in names], dim=-1)

    return concat


def get_loss(config: Dict) -> Callable:
    """Loss by name (accepts 'BcdDiceLoss' [sic] and 'BceDiceLoss',
    ref: src/models/train_model.py:178-184) and 'mse'; a HEADS config gets
    the summed per-head loss."""
    heads = config.get("HEADS") or ()
    if heads:
        return multi_head_loss(heads)
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
