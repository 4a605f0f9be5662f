"""Each fault a cell can have, planted under the timed path of a whole
run (the harness's look for a card skipped), makes ``correct`` false,
while the same run without it compares below every limit. On the CPU at
a small size, in float32, where the program and the reference agree to
rounding; ``card`` runs the same at the cell's own size."""

import time

import pytest
import torch

from benchmark import faults as F
from benchmark import harness as H

TRAIN_SMALL = ({"DIM": [4, 32, 32], "FILTERS": 4, "BATCHSIZE": 2,
                "MIXED_PRECISION": False}, {"patients": 2})
SERVE_SMALL = ({"DIM": [32, 32], "FILTERS": 4, "MIXED_PRECISION": False},
               {"studies": 4, "matrix": [30, 40], "field_mm": 38.4,
                "sample": 4, "head_bias_prob": [0.5, 1e-9]})


def _run(root, cell, device, small, fault=None, seconds=0.3):
    cfg, traffic = small if small else (None, None)
    return H.run_cell(root, cell, 2 ** 31 + 77, seconds, False, device,
                      time.time(), cfg, traffic,
                      faults={"f": fault} if fault else None)


def _held(run, names):
    return {c.name: (c.value, c.limit) for c in run["checks"]
            if c.name in names}


@pytest.mark.parametrize("cell,fault,number", [
    ("cine_3d.train", F.train_unchanged, "change_median_gap"),
    ("cine_3d.train", F.train_half_batch, "grad_median_gap"),
    ("flagship_2d.serve", F.serve_altered, "fp_share"),
    ("flagship_2d.serve", F.serve_cc_bypassed, "cc_component_gap"),
    ("flagship_2d.serve", F.serve_half_batch, "empty_slices")])
def test_fault_fails_the_check(root, cell, fault, number):
    small = SERVE_SMALL if "serve" in cell else TRAIN_SMALL
    sound = _run(root, cell, torch.device("cpu"), small)
    value, limit = _held(sound, {number})[number]
    assert value <= limit
    bad = _run(root, cell, torch.device("cpu"), small, fault)
    value, limit = _held(bad, {number})[number]
    assert value > limit and not bad["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", [
    ("cine_3d.train", F.train_unchanged),
    ("cine_3d.train", F.train_half_batch),
    ("flagship_2d.serve", F.serve_altered),
    ("flagship_2d.serve", F.serve_cc_bypassed),
    ("flagship_2d.serve", F.serve_half_batch)])
def test_fault_fails_the_check_at_the_cells_size(root, card, cell, fault):
    assert not _run(root, cell, card, None, fault, seconds=1.0)["correct"]
