"""One rank of the multi-process checks of ``tests/test_torch_multiprocess.py``
(gloo on the CPU). Imports only cmrtpu_torch; writes its results to
``<dir>/<case>_rank<r>.npz``.

    python tests/torch_mp_worker.py <case> <rank> <world> <dir>

``case`` is ``steps`` (the rendezvous, the global-view and
explicit-collectives steps, the sharded cache) or ``cli`` (cli.train over
the ranks). The inputs come from ``<dir>/inputs.npz`` and
``<dir>/cases.json``.
"""

import json
import os
import sys
import types

import numpy as np
import torch

torch.set_num_threads(1)

from cmrtpu_torch.parallel import mesh as M  # noqa: E402


def _trainer(cfg, state_dict=None):
    from cmrtpu_torch.models.hybrids import get_model
    from cmrtpu_torch.train.trainer import Trainer
    model = get_model(cfg)
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    return Trainer(cfg, model=model, device="cpu")


def _weights(arrays, prefix):
    return {k[len(prefix):]: arrays[k] for k in arrays.files
            if k.startswith(prefix)}


def _model_out(out, tag, trainer):
    for name, p in trainer.model.named_parameters():
        out[f"{tag}/param/{name}"] = p.detach().numpy()
        if p.grad is not None:
            out[f"{tag}/grad/{name}"] = p.grad.numpy()
    for name, b in trainer.model.named_buffers():
        out[f"{tag}/buffer/{name}"] = b.numpy()


class LazyGen:
    """Rows on demand, recording the ids asked for (no host cache)."""
    masks = True

    def __init__(self, x, y):
        self._x, self._y = x, y
        self.images = list(range(len(x)))
        self._cache_x = self._cache_y = None
        self.requested = []

    def fixed_rows(self, ids):
        ids = np.asarray(ids, int)
        self.requested.append(ids)
        return self._x[ids], self._y[ids]


def steps(rank, inputs, cases, out):
    from cmrtpu_torch.train import device_cache as dc
    from cmrtpu_torch.train.device_cache import DeviceCachedLoop

    one = torch.tensor([float(rank + 1)])
    torch.distributed.all_reduce(one)
    out["all_reduce"] = one.numpy()

    xs, ys = inputs["xs"], inputs["ys"]
    idxs = torch.from_numpy(inputs["idxs"]).long()
    init = _weights(inputs, "init/")
    for tag in ("global", "augment", "manual_bf16", "manual_f32", "remat"):
        trainer = _trainer(cases[tag], init)
        loop = DeviceCachedLoop(trainer, types.SimpleNamespace(
            _cache_x=xs, _cache_y=ys, masks=True))
        with M.record_collectives() as calls:
            logs = loop.train_step(idxs)
        out[f"{tag}/collectives"] = np.array(calls)
        for k, v in logs.items():
            out[f"{tag}/log/{k}"] = v.numpy()
        _model_out(out, tag, trainer)

    # the sharded cache at an odd N, rows loaded per rank
    cfg = cases["sharded"]
    train = LazyGen(inputs["sx"], inputs["sy"])
    val = LazyGen(inputs["vx"], inputs["vy"])
    trainer = _trainer(cfg, _weights(inputs, "sharded_init/"))
    loop = DeviceCachedLoop(trainer, train, val)
    out["sharded/per_host"] = np.array(loop.per_host)
    out["sharded/train_requested"] = np.concatenate(train.requested)
    out["sharded/val_requested"] = np.concatenate(val.requested)
    out["sharded/x_train"] = loop.x_train.view(torch.int16).numpy()
    out["sharded/y_train"] = loop.y_train.numpy()
    out["sharded/x_val"] = loop.x_val.view(torch.int16).numpy()
    x_tail, _, tail_ids = loop._val_tail
    out["sharded/x_tail"] = x_tail.index_select(0, tail_ids).view(
        torch.int16).numpy()
    with M.record_collectives() as calls:
        logs = loop.run_eval_epoch()
    out["sharded/eval_collectives"] = np.array(calls)
    for k, v in logs.items():
        out[f"sharded/eval/{k}"] = np.array(v)
    drawn = []
    draw = loop._epoch_indices_sharded
    loop._epoch_indices_sharded = lambda: drawn.append(draw()) or drawn[-1]
    for epoch in range(2):  # CACHE_RESHUFFLE_EPOCHS 1: before epoch 1
        with M.record_collectives() as calls:
            logs = loop.run_train_epoch()
        out[f"sharded/epoch{epoch}_collectives"] = np.array(calls)
        for k, v in logs.items():
            out[f"sharded/epoch{epoch}/{k}"] = np.array(v)
        out[f"sharded/x_train_epoch{epoch}"] = \
            loop.x_train.view(torch.int16).numpy()
        out[f"sharded/y_train_epoch{epoch}"] = loop.y_train.numpy()
    out["sharded/indices"] = np.stack(drawn)
    _model_out(out, "sharded", trainer)

    # a streamed epoch: each rank takes its rows of every host batch
    from cmrtpu_torch.pipeline.generator import DataGenerator
    from cmrtpu_torch.train.streaming import StreamedLoop
    cfg = cases["streamed"]
    trainer = _trainer(cfg, _weights(inputs, "streamed_init/"))
    gen = DataGenerator(*cases["slices"], config=cfg, device="cpu")
    with M.record_collectives() as calls:
        logs = StreamedLoop(trainer, gen).run_train_epoch()
    out["streamed/collectives"] = np.array(calls)
    for k, v in logs.items():
        out[f"streamed/log/{k}"] = np.array(v)
    _model_out(out, "streamed", trainer)

    # Trainer.fit over finalized host batches
    trainer = _trainer(cases["augment"], init)
    batches = [(inputs["fit_x"][i:i + 8], inputs["fit_y"][i:i + 8])
               for i in range(0, 16, 8)]
    with M.record_collectives() as calls:
        history = trainer.fit(batches, val_data=batches[:1], epochs=2)
    out["fit/collectives"] = np.array(calls)
    out["fit/loss"] = np.array([h["loss"] for h in history])
    out["fit/val_loss"] = np.array([h["val_loss"] for h in history])
    _model_out(out, "fit", trainer)

    # one rank's masks are not small integers: neither packs to uint8
    for tag, odd in (("veto", rank == 1), ("agreed", False)):
        y = inputs["sy"][:4] + (0.5 if odd else 0.0)
        _, yt, padded = dc.upload_cache_sharded_per_host(
            lambda ids, y=y: (inputs["sx"][:4][ids % 4], y[ids % 4]), 4,
            trainer.mesh, torch.device("cpu"), cfg)
        out[f"{tag}/y_dtype"] = np.array(str(yt.dtype))


def cli(rank, inputs, cases, out, work):
    from cmrtpu_torch.cli.train import main as train_main
    from cmrtpu_torch.train import fold as F

    trained = []
    orig = F.train_fold

    def spy(*a, **k):
        trained.append(orig(*a, **k))
        return trained[-1]

    F.train_fold = spy
    for tag in ("cli_replicated", "cli_sharded"):
        # each run's group has its own rendezvous
        os.environ["JAX_COORDINATOR_ADDRESS"] = \
            "file://" + os.path.join(work, f"rendezvous_{tag}")
        cfg_path = os.path.join(work, f"{tag}.json")
        exp = train_main(["-cfg", cfg_path, "-data",
                          os.path.join(work, "data"), "--device", "cpu"])
        out[f"{tag}/exp"] = np.array(exp)
        _model_out(out, tag, trained[-1])
        for key in ("loss", "val_loss"):
            out[f"{tag}/{key}"] = np.array(
                [h[key] for h in trained[-1].history])


def main():
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    out = {}
    if case == "cli":  # the CLI joins the group itself, from the variables
        cli(rank, None, None, out, work)
    else:
        assert M.initialize_distributed(
            "file://" + os.path.join(work, "rendezvous"), world, rank,
            device="cpu", timeout_s=60)
        with open(os.path.join(work, "cases.json")) as fh:
            cases = json.load(fh)
        steps(rank, np.load(os.path.join(work, "inputs.npz")), cases, out)
        M.shutdown_distributed()
    np.savez(os.path.join(work, f"{case}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
