"""cmrtpu_torch's host streaming against cmrtpu's on the CPU.

* ``raw_batch`` of the same files: images bit for bit equal to cmrtpu's for
  STREAM_DTYPE bfloat16 (as 16-bit views), uint8 and float32, masks equal
  and packed alike, in memory and not; a dataset that mixes packable and
  unpackable masks raises ``ValueError`` in both.
* The batch API: ``len``, the order ``on_epoch_end`` gives over three
  epochs, and ``fixed_rows`` equal to cmrtpu's; ``__getitem__`` with
  HIST_MATCHING (AUGMENT_PROB 0, so only the host matcher, whose draws
  come from the generator's numpy rng, changes the batch) within 1e-5 of
  cmrtpu's finalized batch.
* The streamed step's histogram matching against cmrtpu's streamed step
  (``make_cached_train_step(cache_sharded=True)`` with the batch as its
  cache) with cmrtpu's draws injected: the first rows matched against rows
  of the batch, loss and metrics within rel 1e-5.
* ``run_experiment`` of both packages on one written dataset through the
  streamed loop (DEVICE_CACHE_LIMIT_GB below the data), 2 epochs, AUGMENT
  off, dropout 0, f32, from cmrtpu's initial weights: history within rel
  1e-4 (cmrtpu on a 1-device mesh). With HIST_MATCHING both visit the
  same epoch order (the ImageWriter's sample batch draws from the
  generator's rng first in both).
* STREAM_ECHO's step count and warning, the batch-size raise and the
  GRAD_ALLREDUCE_DTYPE routing as cmrtpu's; a swapped optimizer takes
  effect.
* In the port, a streamed epoch equals a device-cached epoch from the same
  weights (SHUFFLE false, bf16 storage, augmentation and dropout on: the
  same draws in the same order): weights exactly, logs within rel 1e-6
  (float32 against float64 averaging).
"""

import logging
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cmrtpu.train.trainer as jax_trainer
from cmrtpu.io import MedicalImage, write_image
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
from cmrtpu.train import device_cache as jax_dc
from cmrtpu.train import steps as S
from cmrtpu.train.fold import run_experiment as jax_run_experiment
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu.train.optimizers import get_optimizer as jax_get_optimizer
import cmrtpu_torch.train.device_cache as port_dc
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.pipeline.generator import DataGenerator
from cmrtpu_torch.pipeline.histmatch import hist_quota
from cmrtpu_torch.train import trainer as port_trainer
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.fold import run_experiment
from cmrtpu_torch.train.streaming import StreamedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_train import CFG, _history, _labels, _write_dataset

torch.set_num_threads(1)

SMALL = dict(CFG, DIM=[24, 24], BATCHSIZE=4, SHUFFLE=True,
             MONITOR_LOCALISATION=False)


def _write_slices(root, n=10, shape=(26, 22), seed=1, masks=None):
    """``n`` image/label nrrd pairs; ``masks`` overrides the label maps."""
    rng = np.random.default_rng(seed)
    msks = _labels(rng, n, *shape) if masks is None else masks
    xs, ys = [], []
    for i in range(n):
        img = rng.normal(300.0, 60.0, shape).astype(np.float32)
        img += 400.0 * (msks[i] > 0)
        xp = str(root / f"patient{i:03d}__t01_z0_img.nrrd")
        yp = str(root / f"patient{i:03d}__t01_z0_msk.nrrd")
        write_image(MedicalImage(array=img, spacing=(1.25, 1.25)), xp)
        write_image(MedicalImage(array=msks[i], spacing=(1.25, 1.25)), yp)
        xs.append(xp)
        ys.append(yp)
    return xs, ys


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write_slices(tmp_path_factory.mktemp("slices"))


@pytest.mark.parametrize("in_memory", [True, False], ids=["memory", "disk"])
@pytest.mark.parametrize("dtype", ["bfloat16", "uint8", "float32"])
def test_raw_batch_bits_match_cmrtpu(files, dtype, in_memory):
    cfg = dict(SMALL, STREAM_DTYPE=dtype)
    ref = JaxGenerator(*files, config=cfg, in_memory=in_memory)
    port = DataGenerator(*files, config=cfg, in_memory=in_memory,
                         device="cpu")
    assert len(port) == len(ref) == 2
    for i in range(len(ref)):
        want_x, want_y = ref.raw_batch(i)
        x, y = port.raw_batch(i)
        if dtype == "bfloat16":
            assert want_x.dtype == ml_dtypes.bfloat16
            assert x.dtype == torch.bfloat16
            np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                          want_x.view(np.int16))
        else:
            assert x.numpy().dtype == want_x.dtype
            np.testing.assert_array_equal(x.numpy(), want_x)
        assert y.numpy().dtype == want_y.dtype == np.uint8
        np.testing.assert_array_equal(y.numpy(), want_y)


def test_mixed_mask_packability_raises_as_cmrtpu(tmp_path):
    masks = np.zeros((8, 16, 16), np.float32)
    masks[:4, 4:6, 4:6] = 1.0   # exact small integers: packable
    masks[4:, 4:6, 4:6] = 0.5   # fractional: not
    files = _write_slices(tmp_path, n=8, shape=(16, 16), masks=masks)
    cfg = dict(SMALL, DIM=[16, 16], SHUFFLE=False, MASK_VALUES=[1],
               MASK_CLASSES=1, RESAMPLE=False)
    for gen in (JaxGenerator(*files, config=cfg, in_memory=False),
                DataGenerator(*files, config=cfg, in_memory=False)):
        _, msks = gen.raw_batch(0)  # the first batch fixes uint8 packing
        assert np.asarray(msks).dtype == np.uint8
        with pytest.raises(ValueError, match="uint8"):
            gen.raw_batch(1)


@pytest.mark.parametrize("shuffle", [True, False])
def test_len_order_and_fixed_rows_match_cmrtpu(files, shuffle):
    cfg = dict(SMALL, SHUFFLE=shuffle, BATCHSIZE=3)
    ref = JaxGenerator(*files, config=cfg, in_memory=False)
    port = DataGenerator(*files, config=cfg, in_memory=False)
    assert len(port) == len(ref) == 3
    for _ in range(3):
        np.testing.assert_array_equal(port.indices, ref.indices)
        port.on_epoch_end()
        ref.on_epoch_end()
    ids = np.array([7, 0, 3, 3])
    for got, want in zip(port.fixed_rows(ids), ref.fixed_rows(ids)):
        np.testing.assert_array_equal(got, want)
    memory = DataGenerator(*files, config=cfg)
    for got, want in zip(memory.fixed_rows(ids), ref.fixed_rows(ids)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_memory", [True, False], ids=["memory", "disk"])
def test_getitem_with_host_hist_matching_matches_cmrtpu(files, in_memory):
    # SHUFFLE false: the generator without the matcher visits the same rows
    cfg = dict(SMALL, AUGMENT=True, AUGMENT_PROB=0.0, HIST_MATCHING=True,
               SHUFFLE=False)
    ref = JaxGenerator(*files, config=cfg, in_memory=in_memory)
    port = DataGenerator(*files, config=cfg, in_memory=in_memory,
                         device="cpu")
    plain = DataGenerator(*files, config=dict(cfg, HIST_MATCHING=False),
                          in_memory=in_memory, device="cpu")
    matched = 0
    for _ in range(3):
        for i in range(len(ref)):
            want_x, want_y = ref[i]
            x, y = port[i]
            np.testing.assert_allclose(x.numpy(), np.asarray(want_x),
                                       atol=1e-5)
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       atol=1e-5)
            matched += int(not torch.equal(x, plain[i][0]))
        for gen in (ref, port, plain):
            gen.on_epoch_end()
    assert matched  # the matcher changed at least one batch
    # both drew the same numbers from their rngs
    assert port._rng.random() == ref._rng.random()


def test_streamed_step_hist_matching_matches_cmrtpu(monkeypatch):
    """The streamed step is cmrtpu's sharded step over the batch: its
    candidates are the batch's first rows, its references rows of the
    batch."""
    cfg = dict(CFG, BATCHSIZE=8, ACTIVATION="elu", HIST_MATCHING=True,
               HIST_MATCHING_PROB=0.3, AUGMENT=True, AUGMENT_PROB=0.0,
               MONITOR_LOCALISATION=False)
    rng = np.random.default_rng(4)
    xs = rng.random((8, 32, 32)).astype(np.float32)
    xs[:, :3] = 0.0  # a zero border, as the padded slices have
    ys = _labels(rng, 8, 32, 32)
    batch_x = xs.astype(ml_dtypes.bfloat16)
    model = jax_build_model(cfg)
    variables = init_variables(model, cfg,
                               jax.random.key(3, impl="threefry2x32"))
    init = jax.tree_util.tree_map(np.array, dict(variables["params"]))
    mesh = create_mesh(devices=jax.devices()[:1])
    optimizer = jax_get_optimizer(cfg)
    step = jax_dc.make_cached_train_step(
        model, optimizer, jax_get_loss(cfg), jax_default_metrics(2), cfg,
        mesh, augment=True, cache_sharded=True)
    state = S.create_train_state(model, variables, optimizer)
    rng_key = jax.random.key(0)
    _, ref_logs = step(state, jnp.asarray(batch_x), jnp.asarray(ys),
                       jnp.arange(8, dtype=jnp.int32), rng_key)

    # cmrtpu's draws of step 0 (device_cache._sharded_gather, one shard)
    quota, gate_p = hist_quota(0.3, 8)
    hm_key = jax.random.fold_in(jax.random.fold_in(rng_key, 0x415), 0)
    k_ref, k_gate = jax.random.split(jax.random.fold_in(hm_key, 0))
    ref_idx = np.array(jax.random.randint(k_ref, (quota,), 0, 8))
    gate = np.array(jax.random.bernoulli(k_gate, gate_p, (quota,)))
    assert gate.any()
    drawn = []

    def injected(generator, batch, n_cache, q, p, first_rows=False):
        drawn.append((batch, n_cache, q, p, first_rows))
        return (torch.arange(q), torch.from_numpy(ref_idx),
                torch.from_numpy(gate))

    monkeypatch.setattr(port_dc, "draw_match", injected)
    port = get_model(cfg)
    port.load_state_dict(flax_to_state_dict(init))
    trainer = Trainer(cfg, model=port, device="cpu")
    gen = types.SimpleNamespace(masks=True)
    loop = StreamedLoop(trainer, gen)
    logs = loop.train_batch(torch.from_numpy(xs).to(torch.bfloat16),
                            torch.from_numpy(ys).to(torch.uint8),
                            torch.arange(8))
    assert drawn == [(8, 8, quota, gate_p, True)]
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert float(v) == pytest.approx(float(ref_logs[k]), rel=1e-5,
                                         abs=1e-6), k


def test_streamed_run_experiment_matches_cmrtpu(tmp_path, monkeypatch):
    cfg = dict(CFG, HEAD_BIAS_PRIOR=0.001, DEVICE_CACHE_LIMIT_GB=1e-9)
    data = _write_dataset(str(tmp_path / "data"))
    captured = {}

    def capture(model, config, rng):
        variables = init_variables(model, config, rng)
        captured["params"] = jax.tree_util.tree_map(
            np.array, dict(variables["params"]))
        return variables

    monkeypatch.setattr(jax_trainer, "init_variables", capture)
    monkeypatch.setattr(jax_trainer, "create_mesh", lambda config: create_mesh(
        config, devices=jax.devices()[:1]))
    jax_exp = jax_run_experiment(dict(cfg), data_path=data,
                                 exp_path=str(tmp_path / "jax"))

    def from_cmrtpu(config, supervision=False):
        model = get_model(config, supervision=supervision)
        model.load_state_dict(flax_to_state_dict(captured["params"]))
        return model

    monkeypatch.setattr(port_trainer, "init_model", from_cmrtpu)
    loops = []
    monkeypatch.setattr(port_trainer.Trainer, "fit_cached",
                        lambda *a, **k: loops.append("cached"))
    torch_exp = run_experiment(dict(cfg), data_path=data,
                               exp_path=str(tmp_path / "torch"),
                               device="cpu")
    assert loops == []  # the fold took the streamed loop
    ref = _history(f"{jax_exp}/f0/history.csv")
    got = _history(f"{torch_exp}/f0/history.csv")
    assert len(got) == len(ref) == 2 and list(got[0]) == list(ref[0])
    for r, g in zip(ref, got):
        for key in r:
            if key != "epoch_time":
                assert float(g[key]) == pytest.approx(
                    float(r[key]), rel=1e-4, abs=1e-6), key


def test_streamed_hist_matching_epoch_order_matches_cmrtpu(tmp_path,
                                                           monkeypatch):
    """With HIST_MATCHING both train_folds draw the ImageWriter's sample
    batch ``batch_generator[0]``, whose host matcher draws from the
    generator's rng, before the fit: the streamed loop then visits
    cmrtpu's order in every epoch. The control, the same generator without
    that draw, visits another order from epoch 1 on."""
    from cmrtpu_torch import config as PC
    from cmrtpu_torch.data.dataset import get_trainings_files

    cfg = dict(CFG, HEAD_BIAS_PRIOR=0.001, DEVICE_CACHE_LIMIT_GB=1e-9,
               HIST_MATCHING=True, AUGMENT=True, AUGMENT_PROB=0.0)
    data = _write_dataset(str(tmp_path / "data"))
    orders = {"jax": [], "port": []}

    def recording(kind, cls):
        real = cls.raw_batch

        def raw_batch(self, index):
            if self.augment and self.hist_matching:  # the train generator
                size = self.batchsize
                orders[kind].append(
                    self.indices[index * size:(index + 1) * size].tolist())
            return real(self, index)
        return raw_batch

    monkeypatch.setattr(JaxGenerator, "raw_batch",
                        recording("jax", JaxGenerator))
    monkeypatch.setattr(DataGenerator, "raw_batch",
                        recording("port", DataGenerator))
    monkeypatch.setattr(jax_trainer, "create_mesh", lambda config: create_mesh(
        config, devices=jax.devices()[:1]))
    jax_run_experiment(dict(cfg), data_path=data,
                       exp_path=str(tmp_path / "jax"))
    torch_exp = run_experiment(dict(cfg), data_path=data,
                               exp_path=str(tmp_path / "torch"),
                               device="cpu")
    x_tr, y_tr, _, _ = get_trainings_files(
        f"{data}/2D", 0, path_to_folds_df=f"{data}/df_kfold.csv")
    steps = len(x_tr) // cfg["BATCHSIZE"]
    assert steps == 2 and len(orders["jax"]) == cfg["EPOCHS"] * steps
    assert orders["port"] == orders["jax"]
    got = _history(f"{torch_exp}/f0/history.csv")
    assert len(got) == 2 and all(np.isfinite(float(r["loss"])) for r in got)

    control = DataGenerator(x_tr, y_tr, config=PC.normalise_config(cfg),
                            device="cpu")
    undrawn = []
    for _ in range(cfg["EPOCHS"]):
        undrawn += [control.indices[i * 4:(i + 1) * 4].tolist()
                    for i in range(steps)]
        control.on_epoch_end()
    assert undrawn[:steps] == orders["jax"][:steps]
    assert undrawn[steps:] != orders["jax"][steps:]


@pytest.fixture(scope="module")
def gens(tmp_path_factory):
    files = _write_slices(tmp_path_factory.mktemp("gens"), n=16)
    cfg = dict(SMALL, SHUFFLE=False)
    return (DataGenerator(files[0][:12], files[1][:12], config=cfg),
            DataGenerator(files[0][12:], files[1][12:], config=cfg), cfg)


def test_stream_echo_steps_and_warning(gens, caplog):
    train, _, cfg = gens
    echo = dict(cfg, STREAM_ECHO=3, AUGMENT=True, RANDOMROTATE=True)
    trainer = Trainer(echo, device="cpu")
    with caplog.at_level(logging.WARNING):
        hist = trainer.fit_streamed(train, epochs=2)
    assert not any("STREAM_ECHO" in r.message for r in caplog.records)
    assert all(np.isfinite(h["loss"]) for h in hist)
    # cmrtpu's count: epochs x len(gen) x STREAM_ECHO
    assert trainer.state.step == 2 * (12 // 4) * 3
    with caplog.at_level(logging.WARNING):
        plain = Trainer(dict(cfg, STREAM_ECHO=2), device="cpu")
        plain.fit_streamed(train, epochs=1)
    assert any("STREAM_ECHO=2 with AUGMENT=False" in r.message
               for r in caplog.records)
    assert plain.state.step == (12 // 4) * 2


def test_streamed_batch_mismatch_raises(gens):
    train, _, cfg = gens
    trainer = Trainer(cfg, device="cpu")

    class _Short:
        masks = True

        def __len__(self):
            return 1

        def raw_batch(self, i):
            x, y = train.raw_batch(i)
            return x[:-1], y[:-1]

    with pytest.raises(ValueError, match="BATCHSIZE"):
        trainer.fit_streamed(_Short(), epochs=1)


def test_grad_allreduce_dtype_routes_the_streamed_step(gens, monkeypatch):
    train, _, cfg = gens
    calls = []
    orig = port_dc.make_manual_train_step

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(port_dc, "make_manual_train_step", spy)
    trainer = Trainer(dict(cfg, GRAD_ALLREDUCE_DTYPE="bfloat16"),
                      device="cpu")
    hist = trainer.fit_streamed(train, epochs=1)
    assert calls == [1] and np.isfinite(hist[-1]["loss"])
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p.grad, p.grad.bfloat16().float()), name
    plain = Trainer(cfg, device="cpu")
    plain.fit_streamed(train, epochs=1)
    assert calls == [1]
    assert not all(torch.equal(p.grad, p.grad.bfloat16().float())
                   for p in plain.model.parameters())


def test_swapped_optimizer_takes_effect(gens):
    train, _, cfg = gens
    trainer = Trainer(cfg, device="cpu")
    trainer.fit_streamed(train, epochs=1)
    trainer.switch_optimizer("sgd")
    before = {n: p.detach().clone() for n, p in
              trainer.model.named_parameters()}
    trainer.fit_streamed(train, epochs=2, initial_epoch=1)
    # sgd at lr 1e-4: each parameter moved by -lr * its last gradient
    # summed over the epoch's steps; at least the last step is sgd's
    assert trainer.optimizer.name == "sgd"
    assert any(not torch.equal(p, before[n])
               for n, p in trainer.model.named_parameters())
    assert trainer.optimizer.param_groups[0]["count"] == 12 // 4


def test_streamed_epoch_equals_cached_epoch(gens):
    train, _, cfg = gens
    cfg = dict(cfg, STREAM_DTYPE="bfloat16", CACHE_DTYPE="bfloat16",
               AUGMENT=True, RANDOMROTATE=True, SHIFTSCALEROTATE=True,
               GRIDDISTORTION=True, DROPOUT_MIN=0.2, DROPOUT_MAX=0.4)
    weights = Trainer(cfg, device="cpu").model.state_dict()
    results = []
    for make in (DeviceCachedLoop, StreamedLoop):
        trainer = Trainer(cfg, device="cpu")
        trainer.model.load_state_dict(weights)
        logs = make(trainer, train).run_train_epoch()
        results.append((logs, {n: p.detach().clone() for n, p in
                               trainer.model.named_parameters()}))
    (cached, p_cached), (streamed, p_streamed) = results
    # the cached loop averages its logs in float32 on the device, the
    # streamed one sums them in float64 on the host
    assert streamed == pytest.approx(cached, rel=1e-6)
    for name, p in p_cached.items():
        assert torch.equal(p, p_streamed[name]), name
    # a control: another batch order moves the weights elsewhere
    trainer = Trainer(dict(cfg, SHUFFLE=True), device="cpu")
    trainer.model.load_state_dict(weights)
    StreamedLoop(trainer, DataGenerator(train.images, train.labels,
                                        config=dict(cfg, SHUFFLE=True))
                 ).run_train_epoch()
    assert not all(torch.equal(p, p_streamed[n])
                   for n, p in trainer.model.named_parameters())
