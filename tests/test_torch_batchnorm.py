"""cmrtpu_torch's BatchNorm in train mode against flax's on the CPU.

* One fused train step of a BatchNorm U-Net (f32, ELU, dropout 0, AUGMENT
  off) from the same weights, against cmrtpu's ``make_cached_train_step``
  with its own Adam: loss and metrics within rel 1e-5; the updated
  parameters and the running mean and variance within 1e-5; then the eval
  forward from the updated state within 1e-4.
* The running averages move by flax's rule (momentum 0.99, the biased batch
  variance), not by ``nn.BatchNorm2d``'s unbiased one.
* ``eval_step`` and the restored ``Predictor`` read the running averages.
* ``run_experiment`` of both packages for 2 epochs on one written dataset
  with a BatchNorm config: history.csv within rel 1e-4, and the port's
  model.npz carries trained statistics that cmrtpu's forward reads the same.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmrtpu.train.trainer as jax_trainer
from cmrtpu.eval.detection import \
    localisation_metrics as jax_localisation_metrics
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu.train import steps as S
from cmrtpu.train.device_cache import make_cached_train_step, upload_cache
from cmrtpu.train.fold import run_experiment as jax_run_experiment
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu.train.optimizers import get_optimizer as jax_get_optimizer
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import BatchNorm
from cmrtpu_torch.pipeline.generator import finalize_batch
from cmrtpu_torch.predict.predictor import Predictor
from cmrtpu_torch.train import trainer as port_trainer
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict,
                                           load_weights_for_model,
                                           save_weights, state_dict_to_flax)
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.fold import run_experiment
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG, _history, _labels, _write_dataset

torch.set_num_threads(1)

BN = dict(CFG, GROUP_NORM=0, BATCH_NORMALISATION=True)


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_bn_train_step_matches_cmrtpu():
    cfg = dict(BN, BATCHSIZE=8, ACTIVATION="elu", LEARNING_RATE=1e-3)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = _labels(rng, 8, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg, jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables))
    mesh = create_mesh(devices=jax.devices()[:1])
    optimizer = jax_get_optimizer(cfg)
    metrics = jax_default_metrics(2)
    metrics.update(jax_localisation_metrics(cfg))
    step = make_cached_train_step(model, optimizer, jax_get_loss(cfg),
                                  metrics, cfg, mesh, augment=False)
    state = S.create_train_state(model, variables, optimizer)
    dx, dy = upload_cache(xs, ys, mesh)
    new_state, ref_logs = step(state, dx, dy, jnp.arange(8, dtype=jnp.int32),
                               jax.random.key(0))

    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init["params"],
                                            init["batch_stats"]))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    logs = DeviceCachedLoop(trainer, gen).train_step(torch.arange(8))

    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
    params, stats = state_dict_to_flax(port.state_dict())
    for tree, ref in ((params, new_state.params),
                      (stats, new_state.batch_stats)):
        got, want = _flat(tree), _flat(ref)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-5, err_msg=name)
    moved = _flat(stats)
    assert not np.allclose(moved[next(k for k in moved if k.endswith(
        "mean"))], 0.0)  # the step moved the running averages

    x = rng.normal(size=(3, 32, 32, 1)).astype(np.float32)
    ref = np.asarray(model.apply({"params": new_state.params,
                                  "batch_stats": new_state.batch_stats},
                                 x, train=False))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_running_averages_use_the_biased_variance():
    bn = BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        2.0, 3.0, (4, 3, 5, 6)).astype(np.float32))
    out = bn(x)
    mean = x.mean(dim=(0, 2, 3))
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * biased,
                               rtol=1e-5, atol=1e-6)
    # train mode normalises with the batch statistics
    torch.testing.assert_close(
        out, (x - mean[:, None, None]) / torch.sqrt(
            biased[:, None, None] + 1e-3), rtol=1e-4, atol=1e-5)
    # eval mode reads the running averages and leaves them alone
    before = bn.running_var.clone()
    ev = bn.eval()(x)
    torch.testing.assert_close(bn.running_var, before)
    torch.testing.assert_close(
        ev, (x - bn.running_mean[:, None, None]) / torch.sqrt(
            bn.running_var[:, None, None] + 1e-3), rtol=1e-4, atol=1e-5)


def test_eval_step_and_predictor_read_running_averages(tmp_path):
    cfg = dict(BN, BATCHSIZE=4)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(4, 32, 32)).astype(np.float32)
    ys = _labels(rng, 4, 32, 32)
    trainer = Trainer(cfg, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    loop = DeviceCachedLoop(trainer, gen, gen)
    loop.train_step(torch.arange(4))
    model = trainer.model
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    val = loop.run_eval_epoch()
    for k, v in model.state_dict().items():  # evaluation moves nothing
        if k in stats:
            assert torch.equal(v, stats[k]), k
    # the eval loss is the one of the forward on the running averages
    x, y = finalize_batch(torch.from_numpy(xs), torch.from_numpy(ys), cfg)
    params, batch_stats = state_dict_to_flax(model.state_dict())
    flax_model = jax_build_model(cfg)
    on_stats = np.array(flax_model.apply(
        {"params": params, "batch_stats": batch_stats}, x.numpy(),
        train=False))
    loss = float(trainer.loss_fn(y, torch.from_numpy(on_stats)))
    assert val["loss"] == pytest.approx(loss, rel=1e-5)
    # the restored model serves from the running averages written to npz
    save_weights(str(tmp_path / "model"), model)
    pred = Predictor(cfg, str(tmp_path / "model"), device="cpu")
    np.testing.assert_allclose(pred.predict(x.numpy()), on_stats, atol=1e-5)


def test_bn_run_experiment_matches_cmrtpu(tmp_path, monkeypatch):
    cfg = dict(BN, HEAD_BIAS_PRIOR=0.001)
    data = _write_dataset(str(tmp_path / "data"))
    captured = {}

    def capture(model, config, rng):
        variables = init_variables(model, config, rng)
        # numpy copies: cmrtpu's fused step donates the state it starts from
        captured["vars"] = jax.tree_util.tree_map(np.array, dict(variables))
        return variables

    monkeypatch.setattr(jax_trainer, "init_variables", capture)
    jax_exp = jax_run_experiment(dict(cfg), data_path=data,
                                 exp_path=str(tmp_path / "jax"))

    def from_cmrtpu(config, supervision=False):
        model = get_model(config, supervision=supervision)
        model.load_state_dict(flax_to_state_dict(
            captured["vars"]["params"], captured["vars"]["batch_stats"]))
        return model

    monkeypatch.setattr(port_trainer, "init_model", from_cmrtpu)
    torch_exp = run_experiment(dict(cfg), data_path=data,
                               exp_path=str(tmp_path / "torch"),
                               device="cpu")
    ref = _history(os.path.join(jax_exp, "f0", "history.csv"))
    got = _history(os.path.join(torch_exp, "f0", "history.csv"))
    assert len(got) == len(ref) == 2
    assert list(got[0]) == list(ref[0])
    for r, g in zip(ref, got):
        for key in r:
            if key == "epoch_time":  # wall clock
                continue
            assert float(g[key]) == pytest.approx(float(r[key]), rel=1e-4,
                                                  abs=1e-6), key

    # the port's model.npz holds trained statistics, read alike by both
    params, stats = jax_ckpt.load_weights(
        os.path.join(torch_exp, "f0", "model"))
    means = [v for k, v in _flat(stats).items() if k.endswith("mean")]
    assert means and not all(np.allclose(m, 0.0) for m in means)
    x = np.random.default_rng(9).normal(size=(3, 32, 32, 1)).astype(
        np.float32)
    in_jax = np.asarray(jax_build_model(cfg).apply(
        {"params": params, "batch_stats": stats}, x, train=False))
    own = load_weights_for_model(os.path.join(torch_exp, "f0", "model"),
                                 get_model(cfg), cfg)
    with torch.no_grad():
        np.testing.assert_allclose(own.eval()(torch.from_numpy(x)).numpy(),
                                   in_jax, atol=1e-4)
