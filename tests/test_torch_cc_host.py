"""The port's host CC filters and ``largest_component_2d`` against cmrtpu's.

On volumes whose slices all have background the host filters equal
cmrtpu's exactly, and equal the port's device filters (their plain
versions on the CPU). On a slice with no background cmrtpu's host filter
drops the slice's only label (it skips each slice's smallest value); the
port keeps it, as both packages' device filters do. Both behaviours are
asserted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.ops import connected_components as jcc
from cmrtpu_torch.ops import connected_components as tcc

torch.set_num_threads(1)


def _labels(seed, shape=(4, 24, 24), density=0.5):
    """A label volume of 0/1/2 with background in every slice."""
    rng = np.random.default_rng(seed)
    vol = np.where(rng.random(shape) < density,
                   rng.integers(1, 3, shape), 0).astype(np.uint8)
    vol[:, 0, 0] = 0
    return vol


def _discs(seed, shape=(4, 24, 24)):
    """Few compact blobs per label and slice (landmark-like)."""
    rng = np.random.default_rng(seed)
    z, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    vol = np.zeros(shape, np.uint8)
    for k in range(z):
        for val in (1, 2):
            for radius in rng.uniform(1.0, 3.5, rng.integers(1, 4)):
                cy, cx = rng.integers(0, h, 2)
                vol[k][np.hypot(yy - cy, xx - cx) <= radius] = val
    return vol


CASES = {"random-0.3": lambda: _labels(0, density=0.3),
         "random-0.6": lambda: _labels(1, density=0.6),
         "discs": lambda: _discs(2),
         "one-label": lambda: (_labels(3) > 0).astype(np.uint8),
         "empty": lambda: np.zeros((3, 16, 16), np.uint8)}

FILTERS = {"2d": (tcc.clean_3d_prediction_2d_cc_host,
                  jcc.clean_3d_prediction_2d_cc_host,
                  tcc.clean_prediction_2d_cc),
           "3d": (tcc.clean_3d_prediction_3d_cc_host,
                  jcc.clean_3d_prediction_3d_cc_host,
                  tcc.clean_prediction_3d_cc)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_host_filter_matches_cmrtpu(kind, case):
    port, ref, device = FILTERS[kind]
    vol = CASES[case]()
    got = port(vol)
    assert got.dtype == vol.dtype and got.shape == vol.shape
    np.testing.assert_array_equal(got, ref(vol))
    np.testing.assert_array_equal(got, device(vol).numpy())


@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_no_background_keeps_its_label(kind):
    """A full slice (2D) or a full volume (3D) of label 1: the port and
    the device filters keep it; cmrtpu's host filter drops it."""
    port, ref, device = FILTERS[kind]
    vol = _labels(4)
    if kind == "2d":
        vol[1] = 1
        lost = np.zeros_like(vol[1])
    else:
        vol[:] = 1
        lost = np.zeros_like(vol)
    got = port(vol)
    np.testing.assert_array_equal(got, device(vol).numpy())
    want = ref(vol)
    if kind == "2d":
        np.testing.assert_array_equal(got[1], vol[1])
        np.testing.assert_array_equal(want[1], lost)
        # the other slices are filtered alike
        np.testing.assert_array_equal(np.delete(got, 1, 0),
                                      np.delete(want, 1, 0))
    else:
        np.testing.assert_array_equal(got, vol)
        np.testing.assert_array_equal(want, lost)


def test_3d_host_filter_refuses_ten_labels():
    vol = np.arange(10, dtype=np.uint8).reshape(1, 2, 5)
    with pytest.raises(ValueError, match="too many labels"):
        tcc.clean_3d_prediction_3d_cc_host(vol)


@pytest.mark.parametrize("case", ["random-0.3", "random-0.6", "discs",
                                  "empty", "full", "tie"])
def test_largest_component_2d_matches_cmrtpu(case):
    rng = np.random.default_rng(5)
    if case.startswith("random"):
        mask = rng.random((20, 24)) < float(case.split("-")[1])
    elif case == "discs":
        mask = _discs(6, (1, 20, 24))[0] > 0
    elif case == "tie":  # two components of 4 pixels: the first one wins
        mask = np.zeros((20, 24), bool)
        mask[2:4, 2:4] = mask[10:12, 10:12] = True
    else:
        mask = np.full((20, 24), case == "full")
    got = tcc.largest_component_2d(torch.from_numpy(mask)).numpy()
    want = np.asarray(jcc.largest_component_2d(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tcc.largest_component_batch(torch.from_numpy(mask[None]))[0])
    with pytest.raises(ValueError):
        tcc.largest_component_2d(torch.from_numpy(mask[None]))
