"""The port's named dice metrics against cmrtpu's.

``dice_coef_squared``, the per-channel dices (background = ch 0, rv = ch
-3, myo/lower = ch -2, lv/upper = ch -1) and ``default_metrics`` on the
same seeded tensors, within 1e-6; a channel the config lacks gives NaN in
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.train import losses as jl
from cmrtpu_torch.train import losses as tl

torch.set_num_threads(1)

NAMES = ["dice_coef_squared", "dice_coef_background", "dice_coef_rv",
         "dice_coef_myo", "dice_coef_lv", "dice_coef_lower",
         "dice_coef_upper"]


def _pair(channels, seed=0):
    rng = np.random.default_rng(seed)
    y_true = (rng.random((2, 12, 12, channels)) < 0.3).astype(np.float32)
    y_pred = rng.random((2, 12, 12, channels)).astype(np.float32)
    return y_true, y_pred


def _both(fn_name, y_true, y_pred):
    got = getattr(tl, fn_name)(torch.from_numpy(y_true),
                               torch.from_numpy(y_pred))
    want = getattr(jl, fn_name)(jnp.asarray(y_true), jnp.asarray(y_pred))
    return float(got), float(want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_named_dice_matches_cmrtpu(name, channels):
    got, want = _both(name, *_pair(channels, seed=channels))
    absent = name == "dice_coef_rv" and channels < 3 \
        or name in ("dice_coef_myo", "dice_coef_lower") and channels < 2
    if absent:
        assert np.isnan(got) and np.isnan(want)
    else:
        assert np.isfinite(got)
        assert abs(got - want) <= 1e-6


def test_aliases_are_the_reference_channels():
    assert tl.dice_coef_lower is tl.dice_coef_myo
    assert tl.dice_coef_upper is tl.dice_coef_lv


@pytest.mark.parametrize("mask_classes", [1, 2, 3, 4])
def test_default_metrics_keep_keys_and_values(mask_classes):
    got, want = tl.default_metrics(mask_classes), \
        jl.default_metrics(mask_classes)
    assert list(got) == list(want)
    y_true, y_pred = _pair(mask_classes, seed=10 + mask_classes)
    for name in got:
        g = float(got[name](torch.from_numpy(y_true),
                            torch.from_numpy(y_pred)))
        w = float(want[name](jnp.asarray(y_true), jnp.asarray(y_pred)))
        assert abs(g - w) <= 1e-6, name
    # named functions now, not lambdas
    assert all(fn.__name__ == name for name, fn in got.items())
