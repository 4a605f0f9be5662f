"""cmrtpu_torch's sharded device cache on one card, the explicit-collectives
step and the fold's loop choice, against cmrtpu on the CPU.

* ``sharded_eval_plan`` over a table of (n_real, n_shards, local_batch),
  equal to cmrtpu's.
* The sharded loop's epoch indices and ``CACHE_RESHUFFLE_EPOCHS`` 1 over
  three epochs against cmrtpu's ``DeviceCachedLoop`` on a 1-device mesh
  with the same SEED: equal index matrices, and after each reshuffle the
  caches on the card equal to cmrtpu's, bit for bit (bfloat16 images).
* One explicit-collectives step against cmrtpu's ``make_manual_train_step``
  on a 1-device mesh (f32, GroupNorm, ELU, dropout 0): loss and metrics
  within rel 1e-5; with 'bfloat16' every gradient the rule reads is
  bfloat16-representable and within one bfloat16 rounding (2^-8 relative)
  plus 1e-3 x max |g| of cmrtpu's cast gradient; with 'float32' the
  gradients are not rounded.
* ``_picks_device_cache`` and ``_steps_per_epoch`` equal to cmrtpu's over
  the replicated, sharded, per-host and streamed (with STREAM_ECHO)
  configs.
* A streamed fold with STREAM_ECHO 2 resumed: it continues at epoch
  ``step // (len x echo)``.
* ``cli.train -inmemory false`` trains, predicts and writes through the
  streamed loop; ``CACHE_PER_HOST`` on one process loads its rows through
  ``fixed_rows`` into the same caches as the in-memory upload, and the
  fold builds its generators without a host cache; the sharded eval
  equals the replicated eval; a MESH_SHAPE larger than the world raises
  with cmrtpu's message.
"""

import os
import types

import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
from cmrtpu.train import device_cache as jax_dc
from cmrtpu.train import fold as jax_fold
from cmrtpu.train import steps as S
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu.train.manual_collectives import \
    make_manual_train_step as jax_manual_step
from cmrtpu.train.trainer import Trainer as JaxTrainer
from cmrtpu_torch.cli.train import main as train_main
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.pipeline.generator import DataGenerator
from cmrtpu_torch.train import device_cache as port_dc
from cmrtpu_torch.train import fold as F
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from cmrtpu_torch.train.device_cache import (DeviceCachedLoop,
                                             sharded_eval_plan)
from cmrtpu_torch.train.streaming import StreamedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_streaming import SMALL, _write_slices
from test_torch_train import CFG, _history, _labels, _write_dataset

torch.set_num_threads(1)

SHARDED = dict(SMALL, DIM=[16, 16], DEPTH=2, CACHE_SHARDED=True,
               CACHE_DTYPE="bfloat16", GRAD_ALLREDUCE_DTYPE="bfloat16")


def _mesh1(cfg=None):
    return create_mesh(cfg, devices=jax.devices()[:1])


@pytest.mark.parametrize("n_real,n_shards,local_batch", [
    (13, 8, 1), (21, 8, 2), (64, 8, 2), (5, 8, 1), (100, 4, 8), (31, 2, 4),
    (9, 8, 4), (3, 8, 2), (40, 1, 16), (120, 1, 16), (7, 1, 16)])
def test_sharded_eval_plan_matches_cmrtpu(n_real, n_shards, local_batch):
    n_padded = -(-n_real // n_shards) * n_shards
    got = sharded_eval_plan(n_real, n_padded, n_shards, local_batch)
    assert got == jax_dc.sharded_eval_plan(n_real, n_padded, n_shards,
                                           local_batch)


def test_epoch_indices_and_reshuffle_match_cmrtpu():
    cfg = dict(SHARDED, CACHE_RESHUFFLE_EPOCHS=1, SEED=11)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(14, 16, 16)).astype(np.float32)
    ys = _labels(rng, 14, 16, 16)
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    ref = jax_dc.DeviceCachedLoop(JaxTrainer(cfg, mesh=_mesh1(cfg)), gen)
    port = DeviceCachedLoop(Trainer(cfg, device="cpu"), gen)
    assert ref.sharded and port.sharded and ref.n_shards == 1
    for epoch in range(3):
        ref._maybe_reshuffle()
        ref._epochs_run += 1
        want = ref._epoch_indices_sharded()
        port._maybe_reshuffle()
        port._epochs_run += 1
        np.testing.assert_array_equal(
            port._epoch_indices(port.n_train, shuffle=True), want)
        np.testing.assert_array_equal(
            port.x_train.view(torch.int16).numpy(),
            np.asarray(ref.x_train).view(np.int16), err_msg=str(epoch))
        np.testing.assert_array_equal(port.y_train.numpy(),
                                      np.asarray(ref.y_train))
    # the reshuffled cache is the host cache under the rng's own draws
    draws = np.random.default_rng(11)
    draws.permutation(14)          # epoch 0's indices
    perm = draws.permutation(14)   # epoch 1's reshuffle, before its indices
    draws.permutation(14)
    perm = perm[draws.permutation(14)]  # epoch 2's reshuffle
    np.testing.assert_array_equal(port.x_train.float().numpy(),
                                  xs[perm].astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))
    # whole epochs draw the same: the next permutation agrees
    trained = DeviceCachedLoop(Trainer(cfg, device="cpu"), gen)
    for _ in range(3):
        assert np.isfinite(trained.run_train_epoch()["loss"])
    assert torch.equal(trained.x_train, port.x_train)
    assert np.array_equal(trained.rng.permutation(9), ref.rng.permutation(9))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_manual_step_matches_cmrtpu(dtype):
    cfg = dict(CFG, BATCHSIZE=8, ACTIVATION="elu", GRAD_ALLREDUCE_DTYPE=dtype,
               CACHE_SHARDED=True, MONITOR_LOCALISATION=False)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = _labels(rng, 8, 32, 32)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg,
                               jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables["params"]))
    # a rule that applies nothing and keeps the gradients it was handed
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jax.numpy.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jax.numpy.zeros_like, grads), grads))
    mesh = _mesh1()
    step = jax_manual_step(model, keep, jax_get_loss(cfg),
                           jax_default_metrics(2), cfg, mesh, augment=False,
                           cache_sharded=True)
    state = S.create_train_state(model, variables, keep)
    dx, dy = jax_dc.upload_cache(xs, ys, mesh)
    new_state, ref_logs = step(state, dx, dy,
                               jax.numpy.arange(8, dtype=jax.numpy.int32),
                               jax.random.key(0))
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, dict(new_state.opt_state)))

    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init))
    trainer = Trainer(cfg, model=port, device="cpu")
    loop = DeviceCachedLoop(trainer, types.SimpleNamespace(
        _cache_x=xs, _cache_y=ys, masks=True))
    logs = loop.train_step(torch.arange(8))
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k
    rounded = []
    for name, p in port.named_parameters():
        g, want = p.grad.numpy(), ref_grads[name].numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(g, want, rtol=2.0 ** -8,
                                   atol=1e-3 * scale, err_msg=name)
        rounded.append(torch.equal(p.grad, p.grad.bfloat16().float()))
    assert all(rounded) if dtype == "bfloat16" else not all(rounded)


@pytest.fixture(scope="module")
def gens(tmp_path_factory):
    files = _write_slices(tmp_path_factory.mktemp("sharded"), n=14,
                          shape=(18, 18))
    return files


@pytest.mark.parametrize("extra", [
    {}, {"CACHE_SHARDED": True},
    {"CACHE_SHARDED": True, "CACHE_PER_HOST": True},
    {"DEVICE_CACHE_LIMIT_GB": 1e-9, "STREAM_ECHO": 3},
    {"DEVICE_CACHE_LIMIT_GB": 1e-9}],
    ids=["replicated", "sharded", "per-host", "streamed-echo", "streamed"])
def test_loop_choice_and_steps_per_epoch_match_cmrtpu(gens, extra):
    cfg = {**SHARDED, "BATCHSIZE": 3, "GRAD_ALLREDUCE_DTYPE": None,
           "CACHE_SHARDED": False, **extra}
    ref = JaxGenerator(*gens, config=cfg)
    port = DataGenerator(*gens, config=cfg)
    mesh = _mesh1(cfg)
    picks = jax_fold._picks_device_cache(cfg, ref, mesh)
    assert F._picks_device_cache(cfg, port) == picks
    assert picks == ("DEVICE_CACHE_LIMIT_GB" not in extra)
    assert F._steps_per_epoch(cfg, port) == \
        jax_fold._steps_per_epoch(cfg, ref, mesh)
    assert F._picks_device_cache(cfg, port) == picks  # memoized


def test_resumed_streamed_fold_continues_at_its_epoch(tmp_path):
    data = _write_dataset(str(tmp_path / "data"))
    cfg = dict(CFG, EXP_PATH=str(tmp_path / "run"), FOLD=0, CC_FILTER=False,
               DEVICE_CACHE_LIMIT_GB=1e-9, STREAM_ECHO=2, EPOCHS=1,
               SAVE_MODEL_FUNCTION="val_loss",
               DATA_PATH_SAX=os.path.join(data, "2D"),
               DF_FOLDS=os.path.join(data, "df_kfold.csv"),
               DATA_PATH_ORIG=os.path.join(data, "original"))
    first = F.train_fold(cfg, device="cpu")
    per_epoch = (9 // 4) * 2  # len(train_gen) x STREAM_ECHO
    assert first.state.step == per_epoch
    again = F.train_fold(dict(cfg, EPOCHS=3, RESUME=True), device="cpu")
    rows = _history(os.path.join(cfg["EXP_PATH"], "f0", "history.csv"))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert again.state.step == 3 * per_epoch


def test_cli_inmemory_false_streams_end_to_end(tmp_path, monkeypatch):
    data = _write_dataset(str(tmp_path / "data"))
    cfg = dict(CFG, EPOCHS=1, EXPERIMENTS_ROOT=str(tmp_path / "exp"),
               AUGMENT=True, RANDOMROTATE=True, STREAM_ECHO=2)
    built = []
    orig = StreamedLoop.__init__

    def spy(self, *a, **k):
        built.append(self)
        orig(self, *a, **k)

    monkeypatch.setattr(StreamedLoop, "__init__", spy)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(__import__("json").dumps(cfg))
    exp = train_main(["-cfg", str(cfg_path), "-data", data, "-inmemory",
                      "false", "--device", "cpu"])
    assert len(built) == 1
    assert built[0].train_gen._cache_x is None  # no host cache
    rows = _history(os.path.join(exp, "f0", "history.csv"))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["val_loss"]))
    fold = os.path.join(exp, "f0")
    assert os.path.exists(os.path.join(fold, "model", "model.npz"))
    assert os.listdir(os.path.join(fold, "pred"))  # the chained pred_fold


def test_per_host_cache_loads_rows_on_one_process(gens, tmp_path,
                                                  monkeypatch):
    cfg = dict(SHARDED, BATCHSIZE=3, CACHE_PER_HOST=True)  # val 4: 3 + 1
    lazy = [DataGenerator(gens[0][:10], gens[1][:10], config=cfg,
                          in_memory=False),
            DataGenerator(gens[0][10:], gens[1][10:], config=cfg,
                          in_memory=False)]
    memory = [DataGenerator(gens[0][:10], gens[1][:10], config=cfg),
              DataGenerator(gens[0][10:], gens[1][10:], config=cfg)]
    per_host = DeviceCachedLoop(Trainer(cfg, device="cpu"), *lazy)
    in_memory = DeviceCachedLoop(Trainer(dict(cfg, CACHE_PER_HOST=False),
                                         device="cpu"), *memory)
    assert per_host.per_host and not in_memory.per_host
    for a, b in ((per_host.x_train, in_memory.x_train),
                 (per_host.y_train, in_memory.y_train),
                 (per_host.x_val, in_memory.x_val),
                 (per_host.y_val, in_memory.y_val)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert np.isfinite(per_host.run_train_epoch()["loss"])
    assert set(per_host.run_eval_epoch()) == set(
        in_memory.run_eval_epoch())

    # the fold builds its generators without a host cache
    seen = []
    orig = port_dc.DeviceCachedLoop.__init__

    def spy(self, trainer, train_gen, val_gen=None):
        seen.append((train_gen.in_memory, val_gen.in_memory))
        orig(self, trainer, train_gen, val_gen)

    monkeypatch.setattr(port_dc.DeviceCachedLoop, "__init__", spy)
    data = _write_dataset(str(tmp_path / "data"))
    F.train_fold(dict(CFG, CACHE_SHARDED=True, CACHE_PER_HOST=True,
                      EPOCHS=1, CC_FILTER=False, FOLD=0,
                      EXP_PATH=str(tmp_path / "run"),
                      DATA_PATH_SAX=os.path.join(data, "2D"),
                      DF_FOLDS=os.path.join(data, "df_kfold.csv"),
                      DATA_PATH_ORIG=os.path.join(data, "original")),
                 device="cpu")
    assert seen == [(False, False)]


def test_sharded_eval_equals_replicated_eval(gens):
    cfg = dict(SHARDED, BATCHSIZE=4)
    train = DataGenerator(gens[0][:8], gens[1][:8], config=cfg)
    val = DataGenerator(gens[0][8:], gens[1][8:], config=cfg)  # 6: 4 + 2
    weights = Trainer(cfg, device="cpu").model.state_dict()
    logs = []
    for sharded in (True, False):
        trainer = Trainer(dict(cfg, CACHE_SHARDED=sharded), device="cpu")
        trainer.model.load_state_dict(weights)
        logs.append(DeviceCachedLoop(trainer, train, val).run_eval_epoch())
    assert logs[0] == pytest.approx(logs[1], rel=1e-6)


def test_mesh_over_several_devices_raises():
    """A MESH_SHAPE larger than the world (one process here) raises with
    cmrtpu's message; one device is fine."""
    cfg = dict(SHARDED, MESH_SHAPE=[2, 1])
    with pytest.raises(AssertionError) as ref:
        create_mesh(cfg, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        Trainer(cfg, device="cpu")
    assert str(got.value) == str(ref.value) == \
        "MESH_SHAPE (2, 1) != #devices 1"
    gen = types.SimpleNamespace(_cache_x=np.zeros((4, 16, 16), np.float32),
                                _cache_y=np.zeros((4, 16, 16), np.float32),
                                masks=True)
    DeviceCachedLoop(Trainer(dict(SHARDED, MESH_SHAPE=[1, 1]), device="cpu"),
                     gen)


def test_finalized_batches_feed_fit(gens):
    """``Trainer.fit`` over a generator's finalized batches (its
    ``__iter__``) trains; the augmentation draws come from the generator's
    own seeded ``torch.Generator``."""
    cfg = dict(SMALL, DIM=[16, 16], DEPTH=2, AUGMENT=True, RANDOMROTATE=True,
               SHIFTSCALEROTATE=True)
    gen = DataGenerator(*gens, config=cfg, device="cpu")
    x, y = gen[0]
    assert x.shape == (4, 16, 16, 1) and y.shape == (4, 16, 16, 2)
    twin_x, twin_y = DataGenerator(*gens, config=cfg, device="cpu")[0]
    assert torch.equal(x, twin_x) and torch.equal(y, twin_y)
    assert not torch.equal(gen[0][0], x)  # the next draw differs
    hist = Trainer(cfg, device="cpu").fit(gen, epochs=2)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
