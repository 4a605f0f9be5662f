"""The port's probe tools (``cmrtpu_torch/tools/{roofline,probe2d,probe3d,
tf_twin_ab}.py``) on the CPU.

* ``count_step``'s FLOPs of a tiny U-Net's forward and backward equal a
  hand count of its convolutions exactly: 2 * k * C_in * C_out * H * W *
  N for each forward conv, three times that with the backward (the input
  gradient and the weight gradient), but twice for the first conv, whose
  input needs no gradient. Its bytes of one add equal three tensors'.
* One row of roofline, probe2d (with ``--base``) and probe3d (REMAT and
  BN_BF16 rows) at 32²: finite counts, no ``error``, no share of a card's
  peak (a host run has none).
* tf_twin_ab: its model-ready tensors equal cmrtpu's tool's on one written
  cohort (within 1e-6), its CoM scoring equals cmrtpu's on the same
  arrays, its copy of the tf_keras twin builds the graph of
  tests/test_tf_parity.py layer for layer, and a run at
  ``--patients 4 --dim 32 --epochs 1 --batch 4`` prints its summary.
"""

import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.tools import probe2d, probe3d, roofline, tf_twin_ab

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _conv_flops(k, cin, cout, h, w, n):
    return 2 * k * cin * cout * h * w * n


def test_flop_count_equals_a_hand_count():
    cfg = {"DIM": [8, 8], "DEPTH": 1, "FILTERS": 2, "MASK_CLASSES": 2,
           "MIXED_PRECISION": False, "BATCH_NORMALISATION": False,
           "USE_UPSAMPLE": True}
    model = build_model(cfg).reset_parameters(torch.Generator().manual_seed(0))
    n = 3
    x = torch.randn(n, 8, 8, 1)
    # (taps, C_in, C_out, H, W) of every conv, forward order
    convs = [(9, 1, 2, 8, 8),   # DownBlock_0.ConvBlock_0: the first
             (9, 2, 2, 8, 8),   # DownBlock_0.ConvBlock_1
             (9, 2, 4, 4, 4),   # bottleneck ConvBlock_0
             (9, 4, 4, 4, 4),   # bottleneck ConvBlock_1
             (9, 4, 2, 8, 8),   # UpBlock_0.Conv_0 after the upsample
             (9, 4, 2, 8, 8),   # UpBlock_0.ConvBlock_0 on the concat
             (9, 2, 2, 8, 8),   # UpBlock_0.ConvBlock_1
             (1, 2, 2, 8, 8)]   # head
    fwd = [_conv_flops(*c, n) for c in convs]
    want = 3 * sum(fwd) - fwd[0]
    cost = roofline.count_step(lambda: model.train()(
        x, generator=torch.Generator()).sum().backward())
    assert cost["flops"] == want
    assert set(cost["flop_ops"]) == {"convolution", "convolution_backward"}
    assert cost["flop_ops"]["convolution"] == sum(fwd)


def test_byte_count_of_one_add():
    a, b = torch.ones(4, 5), torch.ones(4, 5)
    cost = roofline.count_step(lambda: a + b)
    assert cost["bytes"] == 3 * a.numel() * 4 and cost["flops"] == 0
    # a view moves nothing
    assert roofline.count_step(lambda: a.view(20))["bytes"] == 0


def _finite_counts(row):
    assert row["gflop_per_step"] > 0 and row["gb_per_step"] > 0
    assert math.isfinite(row["gflop_per_step"])
    assert "flop_share" not in row and "tflops" not in row  # host run
    assert row["flop_ops"]


def test_roofline_one_row_on_the_cpu(capsys):
    row = roofline.main(["--device", "cpu", "--hw", "32", "--batch", "2",
                         "--steps", "1"])
    _finite_counts(row)
    assert row["device"] == "cpu" and row["step_ms"] > 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1])["gb_per_step"] == row["gb_per_step"]


def test_probe2d_one_row_on_the_cpu():
    row = probe2d.main(["--device", "cpu", "--hw", "32", "--batch", "2",
                        "--steps", "1", "--warmup", "1", "--base",
                        "--set", "GROUP_NORM=4"])
    assert row["overrides"] == {"GROUP_NORM": 4}
    assert row["slices_per_sec"] > 0 and row["speedup"] > 0
    _finite_counts(row["roofline"])
    _finite_counts(row["base_roofline"])


def test_probe3d_rows_on_the_cpu():
    rows = probe3d.main(["--device", "cpu", "--hw", "32", "--frames", "4",
                         "--vols", "2", "--steps", "1", "--warmup", "1",
                         "--only", "base,remat1,remat_full,bn_bf16"])
    assert list(rows) == ["base", "roofline:base", "remat1", "remat_full",
                          "bn_bf16"]
    for name, row in rows.items():
        assert "error" not in row, (name, row)
    _finite_counts(rows["roofline:base"])
    assert all(rows[n]["slices_per_sec"] > 0
               for n in ("base", "remat1", "remat_full", "bn_bf16"))


def _cmrtpu_tool():
    spec = importlib.util.spec_from_file_location(
        "cmrtpu_tf_twin_ab", REPO / "tools" / "tf_twin_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tf_twin_ab_matches_cmrtpus_tool(tmp_path, capsys):
    pytest.importorskip("tensorflow")
    keras = pytest.importorskip("tf_keras")
    from cmrtpu_torch.cli.make_dataset import main as make_dataset_main
    from cmrtpu_torch.data.dataset import get_trainings_files
    from cmrtpu_torch.tools.full_cv_demo import generate_cohort
    from test_tf_parity import build_tf_twin

    root = str(tmp_path / "ab")
    generate_cohort(root, n_patients=4, hw=64)
    make_dataset_main(root, str(tmp_path / "ab" / "original"))
    summary = tf_twin_ab.main(["--root", root, "--patients", "4", "--dim",
                               "32", "--epochs", "1", "--batch", "4"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(summary))
    assert set(summary["torch_mm"]) == set(summary["tf_mm"]) == {"ant",
                                                                 "inf"}

    cfg = {"DIM": [32, 32], "SPACING": [1.2, 1.2], "RESAMPLE": True,
           "DEPTH": 4, "FILTERS": 32, "M_POOL": [2, 2], "F_SIZE": [3, 3],
           "MASK_VALUES": [1, 2], "MASK_CLASSES": 2, "BATCHSIZE": 4,
           "GAUS": True, "SIGMA": 2, "SCALER": "MinMax",
           "MIXED_PRECISION": False, "USE_UPSAMPLE": False,
           "BATCH_NORMALISATION": True, "SEED": 0, "AUGMENT": False}
    xt, yt, _, _ = get_trainings_files(
        f"{root}/2D", fold=0, path_to_folds_df=f"{root}/df_kfold.csv")
    ref = _cmrtpu_tool()
    want_x, want_y = ref.materialize(xt, yt, cfg)
    got_x, got_y = tf_twin_ab.materialize(xt, yt, cfg)
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-6)
    pred = (np.random.default_rng(0).random(got_y.shape) > 0.97) \
        .astype(np.float32)
    gt = (got_y >= 0.5).astype(np.float32)
    want = ref.com_mm_errors(pred, gt, 1.2)
    got = tf_twin_ab.com_mm_errors(pred, gt, 1.2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, nan_ok=True), k

    layers = [(type(l).__name__, l.output_shape) for l in
              tf_twin_ab.build_tf_twin(keras, cfg).layers]
    assert layers == [(type(l).__name__, l.output_shape)
                      for l in build_tf_twin(cfg).layers]
