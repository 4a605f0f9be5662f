"""cmrtpu_torch's loss factories (``weighted_cce_dice_loss``,
``max_volume_loss``, ``loss_with_zero_mask``) against cmrtpu's on the same
numpy inputs, 2D and 3D, within 1e-6 relative (float32 sums in another
order; 1e-6 absolute where a loss is a difference of O(1) terms);
``loss_with_zero_mask`` per voxel, as cmrtpu returns it. A factory loss
trains through ``Trainer(loss_fn=...)``; ``get_loss`` still names no other
loss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.train import losses as jl
from cmrtpu_torch.train import losses as tl

torch.set_num_threads(1)

SHAPES = [(2, 8, 8, 4), (2, 3, 8, 8, 3), (2, 6, 5, 2)]
SHAPE_IDS = ["2d-4ch", "3d-3ch", "2d-2ch"]


def _pair(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32) * scale,
            rng.random(shape).astype(np.float32))


def _both(t_fn, j_fn, y_true, y_pred):
    got = t_fn(torch.from_numpy(y_true), torch.from_numpy(y_pred)).numpy()
    want = np.asarray(j_fn(jnp.asarray(y_true), jnp.asarray(y_pred)))
    return got, want


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_weighted_cce_dice_loss_matches(shape):
    weights = [0.1, 1.0, 2.0, 3.0][:shape[-1]]
    got, want = _both(tl.weighted_cce_dice_loss(weights),
                      jl.weighted_cce_dice_loss(weights), *_pair(shape))
    # CE - dice: the difference of two O(1) terms, each within 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("min_probability", [0.8, 0.3])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_max_volume_loss_matches(shape, min_probability):
    got, want = _both(tl.max_volume_loss(min_probability),
                      jl.max_volume_loss(min_probability), *_pair(shape, 1))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kw,shape", [
    ({}, (2, 8, 8, 1)),
    ({"weight_inplane": True}, (2, 3, 8, 8, 1)),
    ({"weight_inplane": True, "loss": "bce"}, (2, 8, 8, 1)),
    ({"mask_smaller_than": 0.03, "loss": "bce"}, (2, 3, 8, 8, 1)),
], ids=["mse-2d", "weighted-3d", "bce-weighted-2d", "bce-threshold-3d"])
def test_loss_with_zero_mask_matches_per_voxel(kw, shape):
    j_kw, t_kw = dict(kw, xy_shape=8), dict(kw, xy_shape=8)
    if kw.get("loss") == "bce":
        j_kw["loss"], t_kw["loss"] = jl.binary_crossentropy, \
            tl.binary_crossentropy
    got, want = _both(tl.loss_with_zero_mask(**t_kw),
                      jl.loss_with_zero_mask(**j_kw),
                      *_pair(shape, 2, scale=0.05))
    assert got.shape == want.shape
    assert (got <= 1e-7).any() and (got > 1e-7).any()  # the mask bites
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_a_factory_loss_trains_through_the_trainer():
    from cmrtpu_torch.train.trainer import Trainer

    cfg = {"DIM": [16, 16], "DEPTH": 1, "FILTERS": 4, "MASK_CLASSES": 3,
           "SEED": 0, "MIXED_PRECISION": False, "LEARNING_RATE": 1e-2}
    trainer = Trainer(cfg, device="cpu",
                      loss_fn=tl.weighted_cce_dice_loss([0.5, 1.0, 1.0]))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 16, 16, 1)).astype(np.float32))
    y = torch.nn.functional.one_hot(torch.zeros(4, 16, 16, dtype=torch.long),
                                    3).float()
    losses = [float(trainer.state.train_step(x, y)["loss"])
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_get_loss_names_no_other_loss():
    with pytest.raises(NotImplementedError,
                       match="Trainer\\(loss_fn=...\\)"):
        tl.get_loss({"LOSS_FUNCTION": "weighted_cce_dice_loss"})
