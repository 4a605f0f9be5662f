"""cmrtpu_torch's batched ``preprocess_model_input`` against cmrtpu's
per-slice numpy loop.

Phantom studies are made with numpy and the same array goes to both. The
cases cover one slice and the flagship's 8-12, in-plane matrices of
216-256 at 1.37-1.68 mm resampled up (to 1.2 mm) and down (to 1.5 and 1.8
mm), odd and even pad and crop margins, RESAMPLE off, the three scalers
and int16 and float32 studies. The port follows numpy's arithmetic (its
float64 resample with a float32 input's float32 weights, its quantile's
dtype and lerp, its summation order for the Standard scaler), so the gap
allowed is 1e-6: cmrtpu's Robust scaler returns float64, the port
float32. One case holds more than 2**24 values, which ``torch.quantile``
would refuse."""

import numpy as np
import pytest
import torch

from cmrtpu.predict.predictor import preprocess_model_input as reference
from cmrtpu_torch.predict.predictor import _np_sum, preprocess_model_input

torch.set_num_threads(1)

ATOL = 1e-6


def phantom(z: int, ny: int, nx: int, dtype, seed: int) -> np.ndarray:
    """[z, ny, nx]: a bright ellipse per slice, gamma noise and a few hot
    pixels that the 0.999 quantile clips."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:ny, :nx]
    vol = []
    for _ in range(z):
        cy, cx = ny / 2 + rng.normal(0, 5), nx / 2 + rng.normal(0, 5)
        r = ((yy - cy) / (ny * 0.3)) ** 2 + ((xx - cx) / (nx * 0.25)) ** 2
        img = 400 * np.exp(-2 * r) + 150 * (r < 0.3) \
            + rng.gamma(2.0, 20.0, (ny, nx))
        img[rng.random((ny, nx)) < 5e-4] = 3000
        vol.append(img)
    vol = np.stack(vol)
    return np.rint(vol).astype(dtype) if dtype == np.int16 \
        else vol.astype(dtype)


# z, matrix (y, x), in-plane spacing (x, y), dtype, SCALER, RESAMPLE,
# target SPACING; the id names the size resampled to (y x x) and its
# margins to DIM 224
CASES = [
    (1, (216, 216), (1.37, 1.37), np.int16, "MinMax", True, 1.2,
     "z1-int16-minmax-up-247-crop23"),
    (8, (256, 232), (1.68, 1.66), np.float32, "MinMax", True, 1.2,
     "z8-f32-minmax-up-354x325-crop130x101"),
    (12, (256, 256), (1.68, 1.68), np.int16, "MinMax", True, 1.2,
     "z12-int16-minmax-up-358-crop134"),
    (8, (240, 216), (1.37, 1.4), np.int16, "MinMax", True, 1.5,
     "z8-int16-minmax-down-224x197-pad27"),
    (8, (217, 232), (1.37, 1.37), np.float32, "MinMax", True, 1.8,
     "z8-f32-minmax-down-165x177-pad59x47"),
    (8, (219, 229), (1.5, 1.5), np.int16, "MinMax", False, 1.2,
     "z8-int16-minmax-native-pad5-crop5"),
    (8, (216, 240), (1.5, 1.5), np.float32, "MinMax", False, 1.2,
     "z8-f32-minmax-native-pad8-crop16"),
    (8, (241, 219), (1.37, 1.4), np.int16, "Standard", True, 1.5,
     "z8-int16-standard-down-225x200-crop1-pad24"),
    (12, (256, 232), (1.68, 1.68), np.float32, "Standard", True, 1.2,
     "z12-f32-standard-up-358x325"),
    (1, (219, 229), (1.5, 1.5), np.int16, "Standard", False, 1.2,
     "z1-int16-standard-native"),
    (8, (216, 216), (1.37, 1.37), np.int16, "Robust", True, 1.2,
     "z8-int16-robust-up-247"),
    (12, (241, 256), (1.68, 1.6), np.float32, "Robust", True, 1.8,
     "z12-f32-robust-down-214x239-pad10-crop15"),
    (1, (216, 240), (1.5, 1.5), np.float32, "Robust", False, 1.2,
     "z1-f32-robust-native"),
]


@pytest.mark.parametrize(
    "z,matrix,spacing,dtype,scaler,resample,target",
    [c[:-1] for c in CASES], ids=[c[-1] for c in CASES])
def test_preprocess_matches_cmrtpu(z, matrix, spacing, dtype, scaler,
                                   resample, target):
    cfg = {"DIM": [224, 224], "SPACING": [target, target],
           "SCALER": scaler, "RESAMPLE": resample}
    vol = phantom(z, *matrix, dtype, seed=z * 1000 + matrix[0])
    want = reference(vol, spacing, cfg)
    got = preprocess_model_input(vol, spacing, cfg)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (z, 224, 224, 1)
    assert np.abs(got.numpy() - want).max() <= ATOL


def test_preprocess_beyond_torch_quantile_limit():
    """257 slices of 256² (16,842,752 values, over 2**24): the order
    statistics are taken per slice, not by torch.quantile over the
    batch."""
    z = 257
    base = (np.arange(256 * 256) % 4093).reshape(256, 256)
    vol = (base[None] + 7 * np.arange(z)[:, None, None]).astype(np.int16)
    assert vol.size > 2 ** 24
    cfg = {"DIM": [224, 224], "SPACING": [1.2, 1.2], "SCALER": "MinMax",
           "RESAMPLE": False}
    want = reference(vol, (1.2, 1.2), cfg)
    got = preprocess_model_input(vol, (1.2, 1.2), cfg).numpy()
    assert got.shape == want.shape == (z, 224, 224, 1)
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize("n", [1, 7, 8, 100, 128, 129, 1000, 8192, 8193,
                               50176, 61997])
def test_np_sum_is_numpys_float32_sum(n):
    """Row sums in numpy's order: its 8-lane leaves, pairwise halves and
    blocks of 8192 give numpy's float32 sum to the bit."""
    rng = np.random.default_rng(n)
    flat = rng.gamma(2.0, 20.0, (3, n)).astype(np.float32)
    flat[1] -= 40.0  # mixed signs
    got = _np_sum(torch.from_numpy(flat)).numpy()
    want = np.array([np.sum(row) for row in flat], np.float32)
    np.testing.assert_array_equal(got, want)
