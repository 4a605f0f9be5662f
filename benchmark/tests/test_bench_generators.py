"""The traffic generator makes the same inputs from the same seed, and
other inputs from another."""

import numpy as np
import pytest
import torch

from benchmark.traffic import generator as G

CPU = torch.device("cpu")
SLICES = {"patients": 2, "slices": [3, 4], "frame_scales": [1.0, 0.72]}
CINE = {"patients": 2, "positions": [2, 3], "frame_scales": [1.0, 0.72]}
STUDIES = {"studies": 3, "z": [2, 3], "matrix": [40, 48],
           "spacing": [1.37, 1.68], "slice_gap": [5.0, 10.0],
           "field_mm": 57.6}


@pytest.mark.parametrize("kind,traffic,dim", [
    ("slices", SLICES, [48, 48]), ("cine", CINE, [4, 48, 48])])
def test_cohorts_deterministic(kind, traffic, dim):
    make = getattr(G, kind)
    x1, y1 = make(traffic, dim, 2 ** 31 + 9, CPU)
    x2, y2 = make(traffic, dim, 2 ** 31 + 9, CPU)
    x3, _ = make(traffic, dim, 2 ** 31 + 10, CPU)
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    assert x1.shape[1:] == tuple(dim) and y1.dtype == np.uint8
    assert set(np.unique(y1)) == {0, 1, 2}  # both insertion points
    assert x1.shape != x3.shape or not np.array_equal(x1, x3)


def test_studies_deterministic():
    a = G.studies(STUDIES, 77, CPU)
    b = G.studies(STUDIES, 77, CPU)
    c = G.studies(STUDIES, 78, CPU)
    assert len(a) == 3
    for s, t in zip(a, b):
        assert np.array_equal(s["array"], t["array"])
        assert s["spacing"] == t["spacing"] and s["origin"] == t["origin"]
        assert s["array"].dtype == np.int16
        assert 2 <= s["array"].shape[0] <= 3
    assert any(s["spacing"] != t["spacing"] for s, t in zip(a, c))
