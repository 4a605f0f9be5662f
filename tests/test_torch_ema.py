"""cmrtpu_torch's EMA shadow against cmrtpu on the CPU.

* ``ema_update`` against cmrtpu's recurrence over 20 steps (warm-up
  d = min(decay, (1+t)/(10+t)) included), within rel 1e-6: the same
  float32 products and sum, which XLA may contract.
* The eval step, ``serving_params``, ``ModelCheckpoint`` and
  ``restore_weights`` read or reseed the shadow, never the live weights.
* ``run_experiment`` of both packages with ``EMA: 0.9`` (the ``val_``
  columns from the shadow, within rel 1e-4 of cmrtpu's, and model.npz
  holding the shadow) runs resumed in tests/test_torch_resume.py, which
  holds the restored shadow too.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.train import steps as S
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.train import steps as PS
from cmrtpu_torch.train.callbacks import ModelCheckpoint
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict, load_weights,
                                           restore_train_state, save_weights)
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG

torch.set_num_threads(1)


@pytest.mark.parametrize("value,want", [(None, None), (False, None),
                                        (True, 0.999), (0.9, 0.9)])
def test_decay_from_config(value, want):
    cfg = {} if value is None else {"EMA": value}
    assert PS.ema_decay_from_config(cfg) == S.ema_decay_from_config(cfg) \
        == want


@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_ema_update_matches_cmrtpu(decay):
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 3, 3), (4,), (2, 4, 1, 1)]
    ref = [rng.normal(size=s).astype(np.float32) for s in shapes]
    shadow = [torch.from_numpy(a.copy()) for a in ref]
    for step in range(20):
        params = [rng.normal(size=s).astype(np.float32) for s in shapes]
        state = types.SimpleNamespace(step=jnp.int32(step), ema_params=ref)
        ref = [np.asarray(a) for a in S.ema_update(state, params, decay)]
        PS.ema_update(shadow, [torch.from_numpy(p) for p in params], decay,
                      step)
        for got, want in zip(shadow, ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _trainer_with_step(cfg):
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 1)).astype(np.float32))
    y = torch.zeros(4, 32, 32, 2)
    y[:, 8:12, 8:12, 0] = 1.0
    for _ in range(2):
        trainer.state.train_step(x, y)
    return trainer, x, y


def test_eval_serving_and_checkpoint_read_the_shadow(tmp_path):
    cfg = dict(CFG, EMA=0.5, LEARNING_RATE=1e-2)
    trainer, x, y = _trainer_with_step(cfg)
    shadow = trainer.state.ema
    live = dict(trainer.model.named_parameters())
    assert any(not torch.equal(shadow[n], live[n]) for n in shadow)
    # eval reads the shadow: equal to a plain model holding it
    twin = get_model(cfg)
    twin.load_state_dict(trainer.serving_params)
    with torch.no_grad():
        want = trainer.state.loss_fn(y, twin.eval()(x))
    got = trainer.state.eval_step(x, y)["loss"]
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert all(torch.equal(trainer.serving_params[n], shadow[n])
               for n in shadow)
    assert torch.equal(dict(trainer.model.named_parameters())[
        next(iter(shadow))], live[next(iter(shadow))])
    ModelCheckpoint(str(tmp_path), async_write=False).on_epoch_end(
        trainer, 0, {"loss": 0.1})
    saved = flax_to_state_dict(*load_weights(str(tmp_path)))
    for name, tensor in shadow.items():
        assert torch.equal(saved[name], tensor), name
    state = restore_train_state(str(tmp_path))
    for name, tensor in shadow.items():
        assert torch.equal(state["ema"][name], tensor), name


def test_restore_weights_reseeds_the_shadow(tmp_path):
    cfg = dict(CFG, EMA=True)
    trainer, _, _ = _trainer_with_step(cfg)
    other = get_model(cfg).reset_parameters(torch.Generator().manual_seed(9))
    save_weights(str(tmp_path), other)
    trainer.restore_weights(str(tmp_path))
    for name, p in other.named_parameters():
        assert torch.equal(trainer.state.ema[name], p.detach()), name
        assert trainer.state.ema[name].data_ptr() != \
            dict(trainer.model.named_parameters())[name].data_ptr()


def test_off_keeps_no_shadow():
    trainer, _, _ = _trainer_with_step(dict(CFG, EMA=False))
    assert trainer.state.ema is None
    assert trainer.train_state()["ema"] is None
