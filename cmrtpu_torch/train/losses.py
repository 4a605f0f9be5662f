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
The factories ``weighted_cce_dice_loss``, ``max_volume_loss`` and
``loss_with_zero_mask`` build losses a caller passes as
``Trainer(loss_fn=...)``; ``get_loss`` selects none of them by name, as in
cmrtpu, and raises for a name it does not know (cmrtpu falls back to
BceDiceLoss). ``dice_numpy`` is the hard dice of the evaluation, on numpy
masks.
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


def dice_coef_squared(y_true: torch.Tensor,
                      y_pred: torch.Tensor) -> torch.Tensor:
    """Soft dice with squared sums in the denominator, smooth=1."""
    yt = _wide(y_true.reshape(-1))
    yp = _wide(y_pred.reshape(-1))
    intersection = torch.sum(yt * yp)
    return (2.0 * intersection + SMOOTH) / (torch.sum(yt ** 2)
                                            + torch.sum(yp ** 2) + SMOOTH)


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


# named per-channel dices (ref: Loss_and_metrics.py:124-153): lv/upper =
# ch[-1], myo/lower = ch[-2], rv = ch[-3], background = ch[0]
def dice_coef_background(y_true, y_pred) -> torch.Tensor:
    return dice_coef_channel(y_true, y_pred, 0)


def dice_coef_rv(y_true, y_pred) -> torch.Tensor:
    return dice_coef_channel(y_true, y_pred, -3)


def dice_coef_myo(y_true, y_pred) -> torch.Tensor:
    return dice_coef_channel(y_true, y_pred, -2)


def dice_coef_lv(y_true, y_pred) -> torch.Tensor:
    return dice_coef_channel(y_true, y_pred, -1)


dice_coef_lower = dice_coef_myo  # the reference's aliases (ref: :135-147)
dice_coef_upper = dice_coef_lv


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


def weighted_cce_dice_loss(weights) -> Callable:
    """Weighted categorical CE - dice: the probabilities renormalised over
    the channels and clipped to [1e-7, 1 - 1e-7], each channel's CE term
    weighted by ``weights[c]``."""
    w = torch.as_tensor(np.asarray(weights, np.float32))

    def loss_fn(y_true, y_pred):
        p = _wide(y_pred)
        p = torch.clamp(p / p.sum(dim=-1, keepdim=True), _KERAS_EPS,
                        1.0 - _KERAS_EPS)
        cce = -torch.sum(_wide(y_true) * torch.log(p)
                         * w.to(p.device, p.dtype), dim=-1)
        return torch.mean(cce) - dice_coef(y_true, y_pred)

    return loss_fn


def max_volume_loss(min_probability: float = 0.8) -> Callable:
    """1 - the mean over voxels of the largest foreground probability,
    counted only where it exceeds ``min_probability`` (a 4-channel
    output's background channel 0 is left out)."""

    def loss_fn(y_true, y_pred):
        p = y_pred[..., 1:] if y_pred.shape[-1] == 4 else y_pred
        m = torch.amax(_wide(p), dim=-1)
        return 1.0 - torch.mean(m * (m > min_probability).to(m.dtype))

    return loss_fn


def loss_with_zero_mask(loss: Callable = None,
                        mask_smaller_than: float = 0.01,
                        weight_inplane: bool = False,
                        xy_shape: int = 224) -> Callable:
    """A per-voxel loss (``loss``, default the squared error) kept only
    where the single-channel target exceeds ``mask_smaller_than``; with
    ``weight_inplane`` each voxel is weighted by cmrtpu's ramp, 0 at the
    border to 100 at the centre of an ``xy_shape``² plane, plus 1e-7. The
    result is per voxel, as cmrtpu's: the caller reduces it."""
    base = loss or (lambda yt, yp: (yt - yp) ** 2)
    ramp = np.zeros((xy_shape, xy_shape), dtype=np.float32)
    for i, value in enumerate(np.linspace(0, 100, xy_shape // 2)):
        ramp[i:-i or None, i:-i or None] = value
    weights = torch.from_numpy(ramp)[None, None]  # cmrtpu's [1, 1, xy, xy]

    def loss_fn(y_true, y_pred):
        yt, yp = _wide(y_true), _wide(y_pred)
        mask = (yt > mask_smaller_than).to(yt.dtype).squeeze(-1)
        per_vox = base(yt, yp)
        if per_vox.shape != mask.shape:  # the loss kept the channel axis
            per_vox = torch.mean(per_vox, dim=-1)
        out = per_vox * mask
        if weight_inplane:
            out = out * weights.to(out.device, out.dtype) + _KERAS_EPS
        return out

    return loss_fn


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
        f"LOSS_FUNCTION={name!r} names no loss: get_loss selects BceDiceLoss "
        "or mse (cmrtpu falls back to BceDiceLoss, ROADMAP Queue 3); pass "
        "weighted_cce_dice_loss, max_volume_loss or loss_with_zero_mask as "
        "Trainer(loss_fn=...)")


def default_metrics(mask_classes: int) -> Dict[str, Callable]:
    """Per-channel dice metrics of the reference's train metrics
    (ref: src/models/train_model.py:54-59) with corrected indexing."""
    metrics = {"dice_coef_labels": dice_coef_labels}
    # channels -1, -2, -3
    for i, fn in enumerate((dice_coef_lv, dice_coef_myo, dice_coef_rv)):
        if mask_classes > i:
            metrics[fn.__name__] = fn
    return metrics
