"""cmrtpu_torch's connected-component filter against cmrtpu and scipy.

Labels must be equal as int32 arrays to the Pallas kernel (interpret mode on
the CPU), to the XLA ``label_components_2d`` and to scipy's labels relabelled
to min-index ids; kept masks must equal the JAX filter and the host (scipy)
filter. On a CPU tensor the plain torch version runs and the CUDA kernel's
launch counter stays at 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from cmrtpu.ops.connected_components import (clean_3d_prediction_2d_cc_host,
                                             label_components_2d as xla_labels)
from cmrtpu.ops.connected_components import \
    clean_prediction_2d_cc as jax_clean
from cmrtpu.ops.connected_components import \
    largest_component_batch as jax_largest
from cmrtpu.ops.pallas_kernels import converge_labels_pallas
from cmrtpu_torch.ops import connected_components as CC
from cmrtpu_torch.ops.cuda_kernels import converge_labels_cuda

torch.set_num_threads(1)


def serpentine(h=24, w=24):
    m = np.zeros((h, w), np.uint8)
    for r in range(0, h, 2):  # boustrophedon corridor (tests/test_pallas.py)
        m[r, :] = 1
        if r + 1 < h:
            m[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    return m[None]


def tie():
    m = np.zeros((1, 16, 20), np.uint8)
    m[0, 9:12, 2:5] = 1     # 9 px, larger min index
    m[0, 1:4, 14:17] = 1    # 9 px, smaller min index -> kept
    m[0, 14, 18] = 1
    return m


def empty_full_single():
    m = np.zeros((3, 16, 16), np.uint8)
    m[1] = 1
    m[2, 7, 9] = 1
    return m


CASES = {
    "random-0.2": lambda: (np.random.default_rng(1).random((3, 32, 32)) < 0.2),
    "random-0.55": lambda: (np.random.default_rng(2).random((3, 32, 40)) < 0.55),
    "random-0.8": lambda: (np.random.default_rng(3).random((3, 32, 32)) < 0.8),
    "serpentine": serpentine,
    "empty-full-single": empty_full_single,
    "tie": tie,
}


def scipy_min_index_labels(masks):
    """scipy 4-connected labels, each component renamed to its min index."""
    out = np.full(masks.shape, 2 ** 30, np.int32)
    for i, m in enumerate(masks):
        lab, n = scipy.ndimage.label(m)
        first = np.full(n + 1, 2 ** 30, np.int64)
        np.minimum.at(first, lab.ravel(), np.arange(lab.size))
        out[i] = np.where(lab > 0, first[lab], 2 ** 30)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_match_reference(case):
    masks = np.asarray(CASES[case](), np.uint8)
    got = CC.label_components_2d(torch.from_numpy(masks)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(converge_labels_pallas(masks)))
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(xla_labels)(jnp.asarray(masks) > 0)))
    np.testing.assert_array_equal(got, scipy_min_index_labels(masks))


@pytest.mark.parametrize("case", sorted(CASES))
def test_largest_component_matches_reference(case):
    masks = np.asarray(CASES[case](), bool)
    kept = CC.largest_component_batch(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(kept, np.asarray(jax_largest(masks)))
    host = clean_3d_prediction_2d_cc_host(masks.astype(np.uint8)) > 0
    # the host filter takes np.unique(slice)[1:] as the labels, so it drops
    # a slice with no background; the device filters keep it whole
    partial = ~masks.all(axis=(1, 2))
    np.testing.assert_array_equal(kept[partial], host[partial])
    np.testing.assert_array_equal(kept[~partial], masks[~partial])


def test_tie_keeps_smallest_component_id():
    kept = CC.largest_component_batch(torch.from_numpy(tie().astype(bool)))
    assert kept[0, 2, 15] and not kept[0, 10, 3] and not kept[0, 14, 18]


def test_two_touching_labels():
    """Label 1 and label 2 regions interleave and touch; each keeps its own
    biggest component, and the flat result equals cmrtpu's and scipy's."""
    rng = np.random.default_rng(4)
    pred = rng.choice([0.0, 1.0, 2.0], size=(4, 24, 24), p=[0.4, 0.3, 0.3])
    pred[0, 2:8, 2:8] = 1
    pred[0, 5:12, 6:14] = 2    # overlaps the label-1 square's box
    pred[3] = 0                # empty slice passes through
    out = CC.clean_prediction_2d_cc(pred, (1, 2)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_clean(pred, (1, 2))))
    np.testing.assert_array_equal(
        out.astype(np.uint8), clean_3d_prediction_2d_cc_host(
            pred.astype(np.uint8)))
    assert (out != pred).any()  # the filter removed something


def test_cpu_tensor_takes_plain_version_and_never_the_kernel():
    converge_labels_cuda.launches = 0
    masks = torch.from_numpy(np.random.default_rng(5).random((2, 16, 16)) < 0.5)
    CC.clean_prediction_2d_cc(masks.double(), (1,))
    CC.largest_component_batch(masks)
    assert converge_labels_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        converge_labels_cuda(masks)
    assert converge_labels_cuda.launches == 0
