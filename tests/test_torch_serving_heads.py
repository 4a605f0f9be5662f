"""Serving a multi-head fold (HEADS [rvip, 2, sigmoid], [seg, 4, softmax],
the transpose-conv decoder, BatchNorm) through the port's serve CLI on the
CPU, against cmrtpu's ServingEngine + serve_directory on the same
model.npz: each study writes ``_msk_pred`` and ``_seg_pred`` volumes equal
to cmrtpu's, with the same headers and markers. The head kernels are
scaled x50 so no probability sits at a decision boundary."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cmrtpu.io import read_image
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu.models.unet import init_variables
from cmrtpu.predict.serving import ServingEngine as JaxEngine
from cmrtpu.predict.serving import serve_directory as jax_serve_directory
from cmrtpu.train import checkpoint as jax_ckpt
from cmrtpu_torch.cli.serve import main as serve_main
from test_torch_serving import STUDIES, _study

torch.set_num_threads(1)

CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
       "MASK_VALUES": [1, 2], "BATCHSIZE": 4, "MIXED_PRECISION": False,
       "SPACING": [1.0, 1.0], "RESAMPLE": True, "SCALER": "MinMax",
       "BATCH_NORMALISATION": True, "USE_UPSAMPLE": False,
       "HEADS": [["rvip", 2, "sigmoid"], ["seg", 4, "softmax"]],
       "CC_FILTER": True, "SEED": 11}


@pytest.fixture(scope="module")
def fold_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_fold")
    variables = dict(init_variables(jax_build_model(CFG), CFG,
                                    jax.random.key(5, impl="threefry2x32")))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    stats = jax.tree_util.tree_map(np.asarray,
                                   dict(variables["batch_stats"]))
    for name in ("head_rvip", "head_seg"):
        params[name] = {"kernel": params[name]["kernel"] * 50.0,
                        "bias": params[name]["bias"]}
    jax_ckpt.save_weights(str(d / "model"), params, stats)
    (d / "config").mkdir()
    (d / "config" / "config.json").write_text(json.dumps(CFG))
    return str(d)


def test_multihead_serving_matches_cmrtpu(fold_dir, tmp_path):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for name, z, seed in STUDIES:
        _study(str(in_dir / name), z, seed)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jax_engine = JaxEngine(config=CFG,
                           model_path=os.path.join(fold_dir, "model"))
    jax_serve_directory(jax_engine, str(in_dir), str(out_j))
    totals = serve_main(["-exp", fold_dir, "-in", str(in_dir), "-out",
                         str(out_t), "--device", "cpu"])
    assert totals["studies"] == len(STUDIES)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    seg_labels = set()
    for name, z, _ in STUDIES:
        stem = name.split(".")[0]
        record = json.loads((out_t / f"{stem}.done.json").read_text())
        assert record["outputs"] == [f"{stem}_msk_pred.nrrd",
                                     f"{stem}_seg_pred.nrrd"]
        for suffix in ("msk", "seg"):
            a = read_image(str(out_j / f"{stem}_{suffix}_pred.nrrd"))
            b = read_image(str(out_t / f"{stem}_{suffix}_pred.nrrd"))
            assert b.array.shape == (z, 24, 28)
            np.testing.assert_array_equal(b.array, a.array)
            assert (b.spacing, b.origin, b.direction) == \
                (a.spacing, a.origin, a.direction)
        seg_labels |= set(np.unique(b.array).tolist())
    assert len(seg_labels) > 1  # the softmax head predicts structures
