"""The multihead template's flow through cmrtpu_torch on the CPU, against
cmrtpu: the port's make_dataset CLI slices an ACDC-like tree, the demo
tool's ``_write_seg_slices`` adds the per-slice ventricle targets, the port
trains fold 0 with HEADS [rvip, 2, sigmoid], [seg, 4, softmax] and chains
``pred_fold``.

Both packages' ``pred_fold`` then run on the fold's model.npz with its head
kernels scaled x50 (so no probability sits at a decision boundary) and
write equal ``gt/`` and ``pred/`` ``_msk`` and ``_seg`` files, byte for
byte; both packages' ``evaluate_cv`` of the port's tree write the same
df_eval.csv bytes, the seg-dice columns included."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from cmrtpu_torch.cli import make_dataset as cli_md
from cmrtpu_torch.eval.evaluate import evaluate_cv
from cmrtpu_torch.io import read_image
from cmrtpu_torch.predict.predictor import pred_fold
from cmrtpu_torch.tools.full_cv_demo import _write_seg_slices
from cmrtpu_torch.train.checkpoint import load_weights
from cmrtpu_torch.train.fold import train_fold
from test_torch_end_to_end import SHAPE, _fold_cfg, _write_tree
from test_torch_host_copies import _same_file

torch.set_num_threads(1)

HEADS = [["rvip", 2, "sigmoid"], ["seg", 4, "softmax"]]


@pytest.fixture(scope="module")
def multihead_exp(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh_data"))
    os.makedirs(os.path.join(root, "io"))
    _write_tree(root)
    cli_md.cli(["-data_root", root, "-acdc_data",
                os.path.join(root, "original")])
    _write_seg_slices(root)
    exp_root = str(tmp_path_factory.mktemp("mh_exp") / "run")
    cfg = _fold_cfg(root, exp_root, HEADS=HEADS)
    cfg.update(EPOCHS=1, GROUP_NORM=0, BATCH_NORMALISATION=True)
    train_fold(cfg, device="cpu")
    return root, exp_root


def test_seg_slices_written(multihead_exp):
    root, _ = multihead_exp
    msks = sorted(glob.glob(os.path.join(root, "2D", "*_msk.nrrd")))
    segs = sorted(glob.glob(os.path.join(root, "2D", "*_seg.nrrd")))
    assert [m.replace("_msk.", "_seg.") for m in msks] == segs
    labels = set()
    for f in segs:
        labels |= set(np.unique(read_image(f).array).tolist())
    assert labels == {0, 1, 2, 3}


def _scaled_fold(exp_root, out_dir):
    """A copy of the fold's config and model.npz with the head kernels
    scaled x50."""
    from cmrtpu.train import checkpoint as jax_ckpt

    fold_dir = os.path.join(exp_root, "f0")
    cfg = json.load(open(os.path.join(fold_dir, "config", "config.json")))
    params, stats = load_weights(os.path.join(fold_dir, "model"))
    for name, _, _ in HEADS:
        params[f"head_{name}"]["kernel"] = \
            params[f"head_{name}"]["kernel"] * 50.0
    model_dir = os.path.join(out_dir, "model")
    jax_ckpt.save_weights(model_dir, params, stats)
    return dict(cfg, MODEL_PATH=model_dir)


def test_pred_fold_heads_match_cmrtpu(multihead_exp, tmp_path):
    from cmrtpu.predict.predictor import pred_fold as jax_pred_fold

    _, exp_root = multihead_exp
    cfg = _scaled_fold(exp_root, str(tmp_path))
    assert cfg["HEADS"] == HEADS and cfg["CC_FILTER"] and cfg["GAUS"]
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_pred_fold(dict(cfg, EXP_PATH=jax_out))
    assert pred_fold(dict(cfg, EXP_PATH=torch_out), device="cpu")
    names = sorted(os.path.relpath(f, jax_out) for f in glob.glob(
        os.path.join(jax_out, "*", "*.nrrd")))
    assert names == sorted(os.path.relpath(f, torch_out) for f in glob.glob(
        os.path.join(torch_out, "*", "*.nrrd")))
    assert {n.rsplit("_", 1)[1] for n in names} == {"msk.nrrd", "seg.nrrd",
                                                    "cmr.nrrd"}
    labelled = {"msk": 0, "seg": 0}
    for name in names:
        if name.endswith("_cmr.nrrd"):
            continue
        a, b = os.path.join(torch_out, name), os.path.join(jax_out, name)
        assert _same_file(a, b), name
        arr = read_image(a).array
        assert arr.shape == SHAPE
        if name.startswith("pred"):
            labelled[name[-8:-5]] += int((arr > 0).sum())
    assert labelled["msk"] > 0 and labelled["seg"] > 0


def test_df_eval_seg_dice_equals_cmrtpu(multihead_exp, tmp_path):
    from cmrtpu.eval.evaluate import evaluate_cv as jax_evaluate_cv

    root, exp_root = multihead_exp
    out, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    cols = evaluate_cv(exp_root, root, out_csv=out)
    jax_evaluate_cv(exp_root, root, out_csv=ref)
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    for structure in ("rv", "myo", "lv"):
        dice = cols[f"seg_dice_{structure}"]
        assert len(dice) == 4 and all(0.0 <= d <= 1.0 for d in dice)
    assert all(f.endswith("_seg.nrrd") for f in cols["files_seg_pred"])
