"""cmrtpu_torch over two processes (gloo on the CPU) against cmrtpu on a
2-device mesh of the test platform's virtual devices.

Two launches of ``tests/torch_mp_worker.py``, one process a rank, each with
one thread and a timeout after which both are killed; no process group is
ever made in the pytest process. From the same weights (cmrtpu's, bridged)
and rows:

* the rendezvous and one all-reduce (1 + 2 = 3);
* the global-view step (BCE+Dice, BatchNorm, sgd) against
  ``make_cached_train_step``: loss and metrics within rel 1e-5, the mean
  gradient against cmrtpu's within 1e-5 of its largest, parameters and
  BatchNorm averages within atol 3e-4 (cmrtpu's own bound,
  tests/test_sharding.py), equal on both ranks; W = 2 against the port's
  one-process step with augmentation and histogram matching on;
* the explicit-collectives step in bfloat16 and float32 against
  ``make_manual_train_step``;
* the sharded cache at odd N (13 train, 7 val rows): wrap-padded blocks
  bit-equal to cmrtpu's shards, each rank's loader asked for its block
  only (and the eval tail), the epoch index matrices, the eval epoch with
  its tail, two epochs with a reshuffle before the second (caches
  bit-equal, parameters within 3e-4), a uint8 decision one rank vetoes;
* a streamed epoch (each rank its rows of every host batch) against
  cmrtpu's streamed loop, and ``Trainer.fit`` over host batches against
  one process's;
* REMAT true in the global view against cmrtpu's remat step: the
  recompute repeats the rematerialised blocks' all-reduces of BatchNorm's
  statistics, over the same mesh;
* each step's collectives, listed: the cache gather needs none;
* ``cli.train`` over two ranks (replicated and sharded templates): one
  model.npz a run, written by rank 0, and both ranks at the same weights.
"""

import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmrtpu.eval.detection import localisation_metrics as jax_loc_metrics
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.parallel.mesh import create_mesh
from cmrtpu.train import device_cache as jax_dc
from cmrtpu.train import steps as S
from cmrtpu.train.losses import default_metrics as jax_default_metrics
from cmrtpu.train.losses import get_loss as jax_get_loss
from cmrtpu.train.manual_collectives import \
    make_manual_train_step as jax_manual_step
from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
from cmrtpu.train.optimizers import get_optimizer as jax_get_optimizer
from cmrtpu.train.streaming import StreamedLoop as JaxStreamedLoop
from cmrtpu.train.trainer import Trainer as JaxTrainer
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.models.unet import BatchNorm
from cmrtpu_torch.train.checkpoint import (flax_to_state_dict, load_weights,
                                           state_dict_to_flax)
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.trainer import Trainer
from test_torch_streaming import _write_slices
from test_torch_train import CFG, _labels, _write_dataset

torch.set_num_threads(1)

WORLD = 2
TIMEOUT_S = 150
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")
PARAM_ATOL = 3e-4  # cmrtpu's own bound, tests/test_sharding.py:226-229
LOG_RTOL = 1e-5
# the localisation metrics threshold the heatmaps, so a 1e-7 difference in
# a prediction can move a centroid: measured 8.4e-5 relative on loc_mm
LOC_RTOL = 1e-3
GRAD_ATOL = 1e-5   # of the largest |g| of the model: reduction order only
# the explicit-collectives step: one bfloat16 rounding of the mean, plus
# 1e-3 of the largest |g| where cmrtpu's and the port's float32 gradients
# round to neighbouring values (the one-card test's bound,
# tests/test_torch_sharded_cache.py, for both dtypes). Each rank normalises
# its 4 rows alone, and in float32 the gradients land up to 1.4e-4 of the
# largest |g| from cmrtpu's (the global view's 8 rows: under 1e-5).
MANUAL_RTOL, MANUAL_ATOL = 2.0 ** -8, 1e-3

BN = dict(CFG, GROUP_NORM=0, BATCH_NORMALISATION=True, BATCHSIZE=8,
          ACTIVATION="elu", OPTIMIZER="sgd", LEARNING_RATE=0.1)
CASES = {
    "global": BN,
    "augment": dict(BN, AUGMENT=True, RANDOMROTATE=True,
                    SHIFTSCALEROTATE=True, GRIDDISTORTION=True,
                    HIST_MATCHING=True, HIST_MATCHING_PROB=0.5),
    "manual_bf16": dict(BN, GRAD_ALLREDUCE_DTYPE="bfloat16"),
    "manual_f32": dict(BN, GRAD_ALLREDUCE_DTYPE="float32"),
    "remat": dict(BN, REMAT=True),
    "sharded": dict(BN, BATCHSIZE=4, CACHE_SHARDED=True,
                    CACHE_DTYPE="bfloat16", CACHE_RESHUFFLE_EPOCHS=1,
                    SEED=11),
    "streamed": dict(BN, DIM=[24, 24], BATCHSIZE=4, SHUFFLE=False,
                     MONITOR_LOCALISATION=False),
}
N_TRAIN, N_VAL = 13, 7


def _launch(case, work, env=None):
    """Run ``case`` in WORLD worker processes; kill them all on the
    timeout. Returns each rank's results."""
    base = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs, logs = [], []
    for rank in range(WORLD):
        log = open(os.path.join(work, f"{case}_rank{rank}.log"), "w")
        logs.append(log)
        rank_env = dict(base, JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, case, str(rank), str(WORLD), work],
            cwd=work, env=rank_env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        with open(os.path.join(work, f"{case}_rank{rank}.log")) as fh:
            tail = fh.read()[-4000:]
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{tail}"
    return [dict(np.load(os.path.join(work, f"{case}_rank{r}.npz")))
            for r in range(WORLD)]


def _bridged(variables):
    tree = jax.tree_util.tree_map(np.array, dict(variables))
    return {k: v.numpy() for k, v in flax_to_state_dict(
        tree["params"], tree.get("batch_stats")).items()}


@pytest.fixture(scope="module")
def mesh2():
    return create_mesh(devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def run(tmp_path_factory, mesh2):
    """Inputs, the workers' results of the ``steps`` case and the
    sharded case's cmrtpu trainer (whose weights the port starts from)."""
    work = str(tmp_path_factory.mktemp("mp_steps"))
    rng = np.random.default_rng(2)
    inputs = {"xs": rng.normal(size=(16, 32, 32)).astype(np.float32),
              "ys": _labels(rng, 16, 32, 32),
              "idxs": rng.permutation(16)[:8],
              "sx": rng.normal(size=(N_TRAIN, 32, 32)).astype(np.float32),
              "sy": _labels(rng, N_TRAIN, 32, 32),
              "vx": rng.normal(size=(N_VAL, 32, 32)).astype(np.float32),
              "vy": _labels(rng, N_VAL, 32, 32),
              "fit_x": rng.normal(size=(16, 32, 32, 1)).astype(np.float32),
              "fit_y": rng.random((16, 32, 32, 2)).astype(np.float32)}
    variables = jax.tree_util.tree_map(np.asarray, init_variables(
        jax_build_model(BN), BN, jax.random.key(3, impl="threefry2x32")))
    inputs.update({f"init/{k}": v for k, v in _bridged(variables).items()})
    sharded = JaxTrainer(CASES["sharded"], mesh=mesh2)
    inputs.update({f"sharded_init/{k}": v for k, v in _bridged(
        {"params": sharded.state.params,
         "batch_stats": sharded.state.batch_stats}).items()})
    streamed = JaxTrainer(CASES["streamed"], mesh=mesh2)
    inputs.update({f"streamed_init/{k}": v for k, v in _bridged(
        {"params": streamed.state.params,
         "batch_stats": streamed.state.batch_stats}).items()})
    slices = _write_slices(tmp_path_factory.mktemp("mp_slices"), n=12)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    with open(os.path.join(work, "cases.json"), "w") as fh:
        json.dump(dict(CASES, slices=slices), fh)
    results = _launch("steps", work)
    return types.SimpleNamespace(inputs=inputs, variables=variables,
                                 sharded=sharded, streamed=streamed,
                                 slices=slices, ranks=results)


def _metrics(cfg):
    metrics = jax_default_metrics(2)
    metrics.update(jax_loc_metrics(cfg))
    return metrics


def _keep():
    """A rule that applies nothing and keeps the gradients it was handed
    (its state)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _step_ref(run, mesh2, cfg, make_step, optimizer):
    """cmrtpu's step on the 2-device mesh from the bridged weights:
    (new state, logs)."""
    model = jax_build_model(cfg)
    step = make_step(model, optimizer, jax_get_loss(cfg), _metrics(cfg), cfg,
                     mesh2, augment=False)
    state = S.create_train_state(  # fresh buffers: the step donates them
        model, jax.tree_util.tree_map(jnp.asarray, run.variables), optimizer)
    dx, dy = jax_dc.upload_cache(run.inputs["xs"], run.inputs["ys"], mesh2)
    return step(state, dx, dy, jnp.asarray(run.inputs["idxs"], jnp.int32),
                jax.random.key(0))


def _port_tree(out, tag, kind):
    prefix = f"{tag}/{kind}/"
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
            if k.startswith(prefix)}


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_state_close(out, tag, params, batch_stats, atol):
    got_p, got_s = state_dict_to_flax({**_port_tree(out, tag, "param"),
                                       **_port_tree(out, tag, "buffer")})
    for got, want in ((got_p, params), (got_s, batch_stats)):
        got, want = _flat(got), _flat(want)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=atol, err_msg=name)


def _assert_logs(out, tag, ref_logs):
    got = {k[len(tag) + 5:]: float(v) for k, v in out.items()
           if k.startswith(f"{tag}/log/")}
    assert set(got) == set(ref_logs)
    for k, v in got.items():
        rtol = LOC_RTOL if k.startswith("loc_") else LOG_RTOL
        assert v == pytest.approx(float(ref_logs[k]), rel=rtol, abs=1e-6), k


def _assert_grads(out, tag, ref_grads, rtol=0.0, atol=GRAD_ATOL):
    """The gradients the rule read against cmrtpu's, within ``rtol`` and
    ``atol`` of the model's largest |g|."""
    grads = _port_tree(out, tag, "grad")
    assert grads.keys() == ref_grads.keys()
    scale = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    for name, want in ref_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                   rtol=rtol, atol=atol * scale,
                                   err_msg=name)
    return grads


def _assert_ranks_equal(run, tag):
    a, b = run.ranks
    keys = [k for k in a if k.startswith(f"{tag}/param/")
            or k.startswith(f"{tag}/buffer/")]
    assert keys and all(np.array_equal(a[k], b[k]) for k in keys)


def test_rendezvous_and_all_reduce(run):
    assert [float(r["all_reduce"][0]) for r in run.ranks] == [3.0, 3.0]


def test_global_view_step_matches_cmrtpu(run, mesh2):
    cfg = CASES["global"]
    new_state, ref_logs = _step_ref(run, mesh2, cfg, jax_dc.
                                    make_cached_train_step,
                                    jax_get_optimizer(cfg))
    kept, _ = _step_ref(run, mesh2, cfg, jax_dc.make_cached_train_step,
                        _keep())
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, dict(kept.opt_state)))
    for out in run.ranks:
        _assert_logs(out, "global", ref_logs)
        _assert_state_close(out, "global", new_state.params,
                            new_state.batch_stats, PARAM_ATOL)
        _assert_grads(out, "global", ref_grads)
    _assert_ranks_equal(run, "global")


def test_remat_global_view_step_matches_cmrtpu(run, mesh2):
    """REMAT true over two ranks: the recompute reduces BatchNorm's
    statistics over the same mesh (the backward runs outside
    ``global_batch_stats``), so the step is cmrtpu's remat step within the
    global view's bounds, and equal on both ranks."""
    cfg = CASES["remat"]
    new_state, ref_logs = _step_ref(run, mesh2, cfg, jax_dc.
                                    make_cached_train_step,
                                    jax_get_optimizer(cfg))
    kept, _ = _step_ref(run, mesh2, cfg, jax_dc.make_cached_train_step,
                        _keep())
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, dict(kept.opt_state)))
    for out in run.ranks:
        _assert_logs(out, "remat", ref_logs)
        _assert_state_close(out, "remat", new_state.params,
                            new_state.batch_stats, PARAM_ATOL)
        _assert_grads(out, "remat", ref_grads)
    _assert_ranks_equal(run, "remat")


def test_two_ranks_equal_one_with_augmentation(run):
    """The draws are the global batch's on every rank, so two ranks take
    the step one process takes on the same rows; a missing or doubled
    factor W in the gradient mean would move the parameters twice or half
    as far (sgd)."""
    cfg = CASES["augment"]
    model = get_model(cfg)
    model.load_state_dict({k[5:]: torch.from_numpy(v)
                           for k, v in run.inputs.items()
                           if k.startswith("init/")})
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(cfg, model=model, device="cpu")
    loop = DeviceCachedLoop(trainer, types.SimpleNamespace(
        _cache_x=run.inputs["xs"], _cache_y=run.inputs["ys"], masks=True))
    logs = loop.train_step(torch.from_numpy(run.inputs["idxs"]).long())
    moved = max(float((p.detach() - start[n]).abs().max())
                for n, p in model.named_parameters())
    assert moved > 100 * 1e-5  # the step moves far beyond the bound
    for out in run.ranks:
        _assert_logs(out, "augment", logs)
        params = _port_tree(out, "augment", "param")
        for name, p in model.named_parameters():
            np.testing.assert_allclose(params[name].numpy(),
                                       p.detach().numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
        buffers = _port_tree(out, "augment", "buffer")
        for name, b in model.named_buffers():
            np.testing.assert_allclose(buffers[name].numpy(), b.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    _assert_ranks_equal(run, "augment")


@pytest.mark.parametrize("tag", ["manual_bf16", "manual_f32"])
def test_manual_step_matches_cmrtpu(run, mesh2, tag):
    cfg = CASES[tag]
    new_state, ref_logs = _step_ref(run, mesh2, cfg, jax_manual_step,
                                    _keep())
    ref_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, dict(new_state.opt_state)))
    bf16 = tag == "manual_bf16"
    for out in run.ranks:
        _assert_logs(out, tag, ref_logs)
        grads = _assert_grads(out, tag, ref_grads, MANUAL_RTOL,
                              MANUAL_ATOL)
        for name, g in grads.items():
            assert torch.equal(g, g.bfloat16().float()) == bf16, name
        _, stats = state_dict_to_flax({**_port_tree(out, tag, "param"),
                                       **_port_tree(out, tag, "buffer")})
        got, want = _flat(stats), _flat(new_state.batch_stats)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-5, err_msg=name)
    _assert_ranks_equal(run, tag)


@pytest.fixture(scope="module")
def sharded_ref(run):
    """cmrtpu's sharded loop over the same rows: its caches, eval logs,
    index matrices and state after two epochs."""
    gens = [types.SimpleNamespace(_cache_x=run.inputs[x],
                                  _cache_y=run.inputs[y], masks=True)
            for x, y in (("sx", "sy"), ("vx", "vy"))]
    loop = jax_dc.DeviceCachedLoop(run.sharded, *gens)
    ref = {"x_train": np.asarray(loop.x_train).view(np.int16),
           "y_train": np.asarray(loop.y_train),
           "x_val": np.asarray(loop.x_val).view(np.int16),
           "x_tail": np.asarray(loop._val_tail[0]).view(np.int16),
           "eval": loop.run_eval_epoch(), "indices": []}
    draw = loop._epoch_indices_sharded
    loop._epoch_indices_sharded = lambda: ref["indices"].append(draw()) \
        or ref["indices"][-1]
    for epoch in range(2):
        ref[f"epoch{epoch}"] = loop.run_train_epoch()
        ref[f"x_train_epoch{epoch}"] = np.asarray(loop.x_train).view(np.int16)
        ref[f"y_train_epoch{epoch}"] = np.asarray(loop.y_train)
    ref["state"] = run.sharded.state
    return ref


def _block(a, rank):
    n = a.shape[0] // WORLD
    return a[rank * n:(rank + 1) * n]


def test_sharded_blocks_and_per_host_rows(run, sharded_ref):
    local_n, val_n = -(-N_TRAIN // WORLD), -(-N_VAL // WORLD)
    _, tail = jax_dc.sharded_eval_plan(N_VAL, WORLD * val_n, WORLD,
                                       CASES["sharded"]["BATCHSIZE"] // WORLD)
    assert tail  # the eval has a tail
    for rank, out in enumerate(run.ranks):
        assert bool(out["sharded/per_host"])  # the default over 2 processes
        np.testing.assert_array_equal(
            out["sharded/train_requested"],
            np.arange(rank * local_n, (rank + 1) * local_n) % N_TRAIN)
        np.testing.assert_array_equal(
            out["sharded/val_requested"], np.concatenate(
                [np.arange(rank * val_n, (rank + 1) * val_n) % N_VAL, tail]))
        for key in ("x_train", "y_train", "x_val"):
            np.testing.assert_array_equal(out[f"sharded/{key}"],
                                          _block(sharded_ref[key], rank))
        np.testing.assert_array_equal(out["sharded/x_tail"],
                                      sharded_ref["x_tail"])


def test_sharded_eval_with_tail_matches_cmrtpu(run, sharded_ref):
    for out in run.ranks:
        got = {k[len("sharded/eval/"):]: float(v) for k, v in out.items()
               if k.startswith("sharded/eval/")}
        assert got.keys() == sharded_ref["eval"].keys()
        for k, v in got.items():
            assert v == pytest.approx(sharded_ref["eval"][k], rel=LOG_RTOL,
                                      abs=1e-6), k


def test_sharded_epochs_and_reshuffle_match_cmrtpu(run, sharded_ref):
    want = np.stack(sharded_ref["indices"])
    for rank, out in enumerate(run.ranks):
        np.testing.assert_array_equal(out["sharded/indices"], want)
        for epoch in range(2):
            for key in ("x_train", "y_train"):
                np.testing.assert_array_equal(
                    out[f"sharded/{key}_epoch{epoch}"],
                    _block(sharded_ref[f"{key}_epoch{epoch}"], rank))
            for k, v in sharded_ref[f"epoch{epoch}"].items():
                assert float(out[f"sharded/epoch{epoch}/{k}"]) == \
                    pytest.approx(v, rel=1e-4, abs=1e-6), (epoch, k)
        _assert_state_close(out, "sharded", sharded_ref["state"].params,
                            sharded_ref["state"].batch_stats, PARAM_ATOL)
    # the reshuffle moved rows between the ranks
    before = [_block(sharded_ref["x_train_epoch0"], r) for r in range(2)]
    after = run.ranks[0]["sharded/x_train_epoch1"]
    assert any(row.tobytes() in {b.tobytes() for b in before[1]}
               for row in after)
    _assert_ranks_equal(run, "sharded")


def test_streamed_epoch_matches_cmrtpu(run, mesh2):
    """Each rank streams its rows of every host batch; one epoch against
    cmrtpu's streamed loop on the 2-device mesh."""
    cfg = CASES["streamed"]
    logs = JaxStreamedLoop(run.streamed, JaxGenerator(
        *run.slices, config=cfg)).run_train_epoch()
    for out in run.ranks:
        got = {k[len("streamed/log/"):]: float(v) for k, v in out.items()
               if k.startswith("streamed/log/")}
        assert got.keys() == logs.keys()
        for k, v in got.items():
            assert v == pytest.approx(logs[k], rel=1e-4, abs=1e-6), k
        _assert_state_close(out, "streamed", run.streamed.state.params,
                            run.streamed.state.batch_stats, PARAM_ATOL)
    _assert_ranks_equal(run, "streamed")


def test_fit_over_host_batches_equals_one_process(run):
    """Trainer.fit over finalized host batches: each rank its rows, the
    epoch's logs averaged over the ranks, equal to one process's fit."""
    cfg = CASES["augment"]
    model = get_model(cfg)
    model.load_state_dict({k[5:]: torch.from_numpy(v)
                           for k, v in run.inputs.items()
                           if k.startswith("init/")})
    trainer = Trainer(cfg, model=model, device="cpu")
    batches = [(run.inputs["fit_x"][i:i + 8], run.inputs["fit_y"][i:i + 8])
               for i in range(0, 16, 8)]
    history = trainer.fit(batches, val_data=batches[:1], epochs=2)
    for out in run.ranks:
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(out[f"fit/{key}"],
                                       [h[key] for h in history], rtol=1e-5)
        # four sgd steps at lr 0.1: the one step's 1e-5 grows with them
        # (measured 1.6e-5)
        params = _port_tree(out, "fit", "param")
        for name, p in model.named_parameters():
            np.testing.assert_allclose(params[name].numpy(),
                                       p.detach().numpy(), rtol=0, atol=1e-4,
                                       err_msg=name)
        # the epoch's logs averaged over the ranks, and the stop decision
        calls = list(out["fit/collectives"])
        assert calls.count("epoch_logs_mean:float64") == 2
        assert calls.count("all_agree") == 2
    _assert_ranks_equal(run, "fit")


def test_uint8_decision_one_rank_vetoes(run):
    for out in run.ranks:
        assert str(out["veto/y_dtype"]) == "torch.float32"
        assert str(out["agreed/y_dtype"]) == "torch.uint8"


def _bn_layers(cfg):
    return sum(isinstance(m, BatchNorm) for m in get_model(cfg).modules())


def test_step_collectives(run):
    """What one step communicates; nothing before BatchNorm's first
    statistics, so the gather from the cache is communication-free."""
    k = _bn_layers(BN)
    assert k > 0
    global_view = (["all_reduce_sum:float32"] * k
                   + ["all_gather:float32"] * 2
                   + ["all_gather.backward:float32"]
                   + ["all_reduce_sum.backward:float32"] * k
                   + ["grad_mean:float32"])
    want = {"global": global_view, "augment": global_view,
            "manual_bf16": ["grad_mean:bfloat16", "batch_stats_mean:float32",
                            "logs_mean:float32"],
            "manual_f32": ["grad_mean:float32", "batch_stats_mean:float32",
                           "logs_mean:float32"]}
    steps = (N_TRAIN + 1) // WORLD // (CASES["sharded"]["BATCHSIZE"] // WORLD)
    # REMAT true recomputes every Down- and UpBlock in the backward pass,
    # and with it their BatchNorms' all-reduces of the statistics
    model = get_model(CASES["remat"])
    recomputed = sum(isinstance(m, BatchNorm) for name, block in
                     model.named_children()
                     if name.startswith(("DownBlock", "UpBlock"))
                     for m in block.modules())
    assert 0 < recomputed < k
    for out in run.ranks:
        for tag, calls in want.items():
            assert list(out[f"{tag}/collectives"]) == calls, tag
        assert sorted(out["remat/collectives"]) == sorted(
            global_view + ["all_reduce_sum:float32"] * recomputed)
        assert list(out["sharded/epoch0_collectives"]) == global_view * steps
        assert list(out["sharded/epoch1_collectives"]) == \
            ["all_to_all:bfloat16", "all_to_all:uint8"] + global_view * steps
        # one full eval batch gathered; the tail has no collective
        assert list(out["sharded/eval_collectives"]) == \
            ["all_gather:float32"] * 2


def test_cli_train_over_two_ranks(tmp_path):
    work = str(tmp_path)
    _write_dataset(os.path.join(work, "data"))
    root = os.path.join(work, "exp")
    cfgs = {"cli_replicated": dict(CFG, EPOCHS=1, EXPERIMENTS_ROOT=root,
                                   EXPERIMENT="replicated"),
            "cli_sharded": dict(CFG, EPOCHS=2, EXPERIMENTS_ROOT=root,
                                EXPERIMENT="sharded", GROUP_NORM=0,
                                BATCH_NORMALISATION=True, CACHE_SHARDED=True,
                                CACHE_DTYPE="bfloat16",
                                GRAD_ALLREDUCE_DTYPE="bfloat16")}
    for tag, cfg in cfgs.items():
        with open(os.path.join(work, f"{tag}.json"), "w") as fh:
            json.dump(cfg, fh)
    ranks = _launch("cli", work, env={"JAX_NUM_PROCESSES": str(WORLD),
                                      "CMRTPU_DIST_TIMEOUT_S": "60"})
    for tag, cfg in cfgs.items():
        exps = {str(r[f"{tag}/exp"]) for r in ranks}
        assert len(exps) == 1  # rank 0's run dir on both ranks
        fold = os.path.join(exps.pop(), "f0")
        models = [os.path.join(d, f) for d, _, fs in os.walk(fold)
                  for f in fs if f == "model.npz"]
        assert models == [os.path.join(fold, "model", "model.npz")], models
        assert os.listdir(os.path.join(fold, "pred"))  # rank 0's pred_fold
        with open(os.path.join(fold, "history.csv")) as fh:
            assert len(fh.read().splitlines()) == 1 + cfg["EPOCHS"]
        _assert_ranks_equal(types.SimpleNamespace(ranks=ranks), tag)
        for key in ("loss", "val_loss"):
            np.testing.assert_array_equal(ranks[0][f"{tag}/{key}"],
                                          ranks[1][f"{tag}/{key}"])
        # model.npz holds the weights the ranks ended at (the last epoch
        # improved on val_loss or it is the fallback save)
        params, _ = load_weights(os.path.join(fold, "model"))
        assert params
