"""cmrtpu_torch's losses, metrics and landmark detection against cmrtpu's.

The same seeded numpy tensors go to both. Tolerance 1e-6: the same float32
formulas, reductions summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.eval import detection as jdet
from cmrtpu.train import losses as jl
from cmrtpu_torch.eval import detection as tdet
from cmrtpu_torch.train import losses as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(seed, shape=(3, 16, 20, 2)):
    rng = np.random.default_rng(seed)
    y_true = (rng.random(shape) > 0.8).astype(np.float32)
    y_pred = rng.random(shape).astype(np.float32)
    return y_true, y_pred


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*[torch.from_numpy(a) for a in arrays])
    ref = fn_j(*[jnp.asarray(a) for a in arrays])
    return np.asarray(got), np.asarray(ref)


@pytest.mark.parametrize("name", ["dice_coef", "binary_crossentropy",
                                  "bce_dice_loss", "dice_coef_labels"])
def test_losses_match(name):
    y_true, y_pred = _pair(0)
    got, ref = _both(getattr(tl, name), getattr(jl, name), y_true, y_pred)
    np.testing.assert_allclose(got, ref, **TOL)


def test_bce_near_zero_and_one():
    # saturated, clipped and in-between probabilities, both labels
    p = np.array([0.0, 1e-9, 1e-7, 1e-3, 0.5, 1 - 1e-3, 1 - 1e-7, 1.0],
                 np.float32)
    y_pred = np.stack([p, p], axis=-1)[None]
    for label in (0.0, 1.0):
        y_true = np.full_like(y_pred, label)
        got, ref = _both(tl.binary_crossentropy, jl.binary_crossentropy,
                         y_true, y_pred)
        np.testing.assert_allclose(got, ref, **TOL)
        assert np.isfinite(got).all()


def test_default_metrics_and_get_loss():
    y_true, y_pred = _pair(1, (2, 12, 12, 3))
    t_metrics, j_metrics = tl.default_metrics(3), jl.default_metrics(3)
    assert set(t_metrics) == set(j_metrics)
    for name in t_metrics:
        got, ref = _both(t_metrics[name], j_metrics[name], y_true, y_pred)
        np.testing.assert_allclose(got, ref, **TOL, err_msg=name)
    for name in ("BcdDiceLoss", "BceDiceLoss", "mse"):
        got, ref = _both(tl.get_loss({"LOSS_FUNCTION": name}),
                         jl.get_loss({"LOSS_FUNCTION": name}),
                         y_true, y_pred)
        np.testing.assert_allclose(got, ref, **TOL, err_msg=name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.get_loss({"LOSS_FUNCTION": "focal"})


def _heatmaps():
    """Slots with gt and prediction (TP), gt only (FN), prediction only
    (FP), neither, and an off-by-a-few-pixels detection."""
    b, h, w = 4, 24, 20
    y_true = np.zeros((b, h, w, 2), np.float32)
    y_pred = np.zeros((b, h, w, 2), np.float32)
    y_true[0, 4:7, 5:8, 0] = 1.0          # TP, exact
    y_pred[0, 4:7, 5:8, 0] = 0.9
    y_true[0, 15:17, 10:12, 1] = 1.0      # TP, shifted
    y_pred[0, 17:19, 13:15, 1] = 0.8
    y_pred[0, 18, 14, 1] = 0.95           # argmax peak inside the blob
    y_true[1, 8:10, 8:10, 0] = 1.0        # FN
    y_pred[1, 8:10, 8:10, 0] = 0.3
    y_pred[2, 20:22, 2:4, 1] = 0.7        # FP (no gt)
    # example 3 and the other slots: neither side
    return y_true, y_pred


@pytest.mark.parametrize("strategy", ["com", "argmax"])
def test_detection_matches(strategy):
    y_true, y_pred = _heatmaps()
    got_c, got_v = tdet.detect(torch.from_numpy(y_pred), strategy)
    ref_c, ref_v = jdet.detect(jnp.asarray(y_pred), strategy)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), **TOL)


@pytest.mark.parametrize("strategy", ["com", "argmax"])
def test_localisation_metrics_match(strategy):
    cfg = {"SPACING": [1.2, 1.2], "MASK_VALUES": [1, 2],
           "DETECTION_STRATEGY": strategy}
    y_true, y_pred = _heatmaps()
    t_metrics = tdet.localisation_metrics(cfg)
    j_metrics = jdet.localisation_metrics(cfg)
    values = {}
    for name in ("loc_mm", "loc_det", "loc_fp"):
        got, ref = _both(t_metrics[name], j_metrics[name], y_true, y_pred)
        np.testing.assert_allclose(got, ref, **TOL, err_msg=name)
        values[name] = float(got)
    assert values["loc_det"] == pytest.approx(2 / 3)   # 2 TP of 3 gt slots
    assert values["loc_fp"] == pytest.approx(1 / 5)    # 1 FP of 5 empty slots
