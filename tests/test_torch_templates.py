"""Every shipped experiment template trains through cmrtpu_torch on the CPU, mirroring tests/test_template_configs.py
(the same shrink: 32² or the 3D template's [4, 16, 16], depth 2, 4 filters,
batch 4, f32; every behavioural switch kept).

Per template: one step of the port's device-resident loop from label maps
of the template's own rank (histogram matching, augmentation, targets and
BatchNorm or GroupNorm as the template sets them) gives a finite loss; and
one train step on a fixed batch from cmrtpu's initial weights, dropout 0,
gives cmrtpu's loss within rel 1e-5. The sharded-cache template runs the
sharded loop on its one shard with the explicit-collectives step."""

import glob
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from cmrtpu import config as JC
from cmrtpu.train.trainer import Trainer as JaxTrainer
from cmrtpu_torch import config as C
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.pipeline.generator import finalize_batch
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

TEMPLATES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "exp",
    "template_cfgs", "*.json")))
PORTED = TEMPLATES


def _shrunk(path):
    with open(path) as fh:
        cfg = C.normalise_config(json.load(fh))
    dim = [4, 16, 16] if len(cfg["DIM"]) == 3 else [32, 32]
    cfg.update(DIM=dim, DEPTH=2, FILTERS=4, BATCHSIZE=4,
               MIXED_PRECISION=False, EPOCHS=1)
    return cfg


def _label_maps(cfg, rng, n):
    """[n, *DIM] landmark labels (every frame of a 3D example alike), or
    [n, n_heads, *DIM] for HEADS."""
    h, w = cfg["DIM"][-2:]
    lm = np.zeros((n, *cfg["DIM"]), np.float32)
    for i in range(n):
        y, x = rng.integers(4, h - 8, 2)
        lm[i, ..., y:y + 2, x:x + 2] = 1
        lm[i, ..., y + 4:y + 6, x + 2:x + 4] = 2
    if not cfg.get("HEADS"):
        return lm
    seg = rng.integers(0, 4, (n, *cfg["DIM"])).astype(np.float32)
    return np.stack([lm, seg], axis=1)


def test_every_ported_template_is_covered():
    names = {os.path.basename(p) for p in PORTED}
    assert names == {"cine_3d_config.json", "example_config.json",
                     "gaus_sigma2_config.json", "gaus_sigma4_config.json",
                     "histmatch_config.json", "multihead_config.json",
                     "sharded_cache_config.json"}


@pytest.mark.parametrize("path", PORTED,
                         ids=[os.path.basename(p) for p in PORTED])
def test_template_trains_and_matches_cmrtpu(path):
    cfg = _shrunk(path)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8, *cfg["DIM"])).astype(np.float32)
    ys = _label_maps(cfg, rng, 8)

    # the whole loop step, every switch of the template on
    trainer = Trainer(cfg, device="cpu")
    gen = types.SimpleNamespace(_cache_x=xs, _cache_y=ys, masks=True)
    loop = DeviceCachedLoop(trainer, gen)
    assert (loop._match_fn is not None) == bool(cfg["HIST_MATCHING"])
    assert loop.sharded == bool(cfg.get("CACHE_SHARDED"))
    logs = loop.train_step(torch.arange(4))
    assert np.isfinite(float(logs["loss"]))
    assert trainer.state.step == 1

    # one step on a fixed batch from cmrtpu's weights, dropout 0 (and
    # jax's default PRNG, which cmrtpu's Trainer would otherwise switch for
    # the rest of the process)
    det = dict(cfg, DROPOUT_MIN=0.0, DROPOUT_MAX=0.0, PRNG_IMPL="")
    x, y = finalize_batch(torch.from_numpy(xs[:4]), torch.from_numpy(ys[:4]),
                          det)
    ref = JaxTrainer(JC.normalise_config(dict(det)))
    # numpy copies: cmrtpu's step donates the state it starts from
    init = [jax.tree_util.tree_map(np.array, dict(tree))
            for tree in (ref.state.params, ref.state.batch_stats)]
    _, ref_logs = ref.train_step(ref.state, x.numpy(), y.numpy(), ref.rng)
    port = get_model(det)
    port.load_state_dict(flax_to_state_dict(*init))
    logs = Trainer(det, model=port, device="cpu").state.train_step(x, y)
    assert float(logs["loss"]) == pytest.approx(
        float(np.asarray(ref_logs["loss"])), rel=1e-5)

