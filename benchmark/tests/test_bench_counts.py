"""The FLOP and byte counts against hand counts at small shapes."""

import numpy as np
import pytest
import torch

from benchmark.counts import k1_blur, k2_cc
from benchmark.counts.unet import forward_flops, train_step_flops


def tiny(dim, depth=1, filters=2):
    return {"DIM": dim, "DEPTH": depth, "FILTERS": filters,
            "F_SIZE": [3, 3, 3], "M_POOL": [2, 2, 2], "IMG_CHANNELS": 1,
            "MASK_CLASSES": 2, "DROPOUT_MIN": 0.3, "DROPOUT_MAX": 0.5,
            "GROUP_NORM": 2, "BATCH_NORMALISATION": True}


def conv(cin, cout, k, voxels):
    return 2 * cin * cout * k * voxels


def test_unet_2d_depth1_by_hand():
    # 8 x 8, depth 1, 2 filters: down 1->2, 2->2 at 64 px; bottleneck
    # 2->4, 4->4 at 16 px; up conv 4->2 at 64 px, 4->2, 2->2; head 2->2
    hw, low = 64, 16
    convs = [conv(1, 2, 9, hw), conv(2, 2, 9, hw), conv(2, 4, 9, low),
             conv(4, 4, 9, low), conv(4, 2, 9, hw), conv(4, 2, 9, hw),
             conv(2, 2, 9, hw), conv(2, 2, 1, hw)]
    fwd = sum(convs)
    assert forward_flops(tiny([8, 8]), 1) == fwd
    # backward: a weight gradient for every conv, an input gradient for
    # all but the first (its input needs none)
    assert train_step_flops(tiny([8, 8]), 3) == 3 * (fwd + fwd
                                                     + fwd - convs[0])


def test_unet_3d_by_hand():
    # [2, 4, 4], depth 1: the level pools every axis by 2, to [1, 2, 2]
    vox, low = 32, 4
    fwd = (conv(1, 2, 27, vox) + conv(2, 2, 27, vox) + conv(2, 4, 27, low)
           + conv(4, 4, 27, low) + conv(4, 2, 27, vox) + conv(4, 2, 27, vox)
           + conv(2, 2, 27, vox) + conv(2, 2, 1, vox))
    assert forward_flops(tiny([2, 4, 4]), 2) == 2 * fwd


def test_k1_and_k2_by_hand():
    assert k1_blur.taps(2) == 17
    assert k1_blur.bytes_moved(32, 224, 224) == 32 * 224 * 224 * 8
    assert k1_blur.flops(1, 10, 10, 2.0) == 100 * 17 * 2 * 2
    assert k2_cc.bytes_moved(20, 224, 224) == 20 * 224 * 224 * 5


@pytest.mark.parametrize("density", [0.2, 0.5, 0.6, 0.75])
def test_component_count_matches_scipy(density):
    """The serving check's component count against scipy's 4-connected
    labelling, plane by plane."""
    from scipy import ndimage

    from benchmark.drivers.serve import count_components

    rng = np.random.default_rng(int(density * 100))
    mask = rng.random((3, 41, 57)) < density
    four = ndimage.generate_binary_structure(2, 1)
    want = sum(ndimage.label(plane, four)[1] for plane in mask)
    assert count_components(torch.as_tensor(mask)) == want
