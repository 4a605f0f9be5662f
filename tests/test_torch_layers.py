"""cmrtpu_torch/models/layers.py against cmrtpu/models/layers.py on the same
numpy inputs: the resizes up and down (``jax.image.resize``'s half-pixel
centres and its antialiasing triangle when it shrinks) within 1e-6, the
affine helpers within 1e-6 in float32, the numpy helpers exactly, and
``ScaleLayer`` and ``UnetWrapper`` (2D U-Net on bridged weights, resized
256² -> 224² -> 256²) within the U-Net's f32 tolerance 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmrtpu.models import layers as KL
from cmrtpu.models.unet import build_model as jax_build_model
from cmrtpu_torch.models import layers as TL
from cmrtpu_torch.models.unet import build_model
from cmrtpu_torch.train.checkpoint import flax_to_state_dict
from test_torch_unet import perturbed_variables

torch.set_num_threads(1)

RESIZES = [((2, 3, 40, 48, 2), (32, 32)), ((2, 3, 20, 24, 2), (32, 40)),
           ((1, 2, 64, 64, 1), (56, 56)), ((1, 2, 56, 56, 1), (64, 64)),
           ((1, 1, 30, 17, 3), (45, 9))]
RESIZE_IDS = ["down", "up", "256-to-224-scaled", "224-to-256-scaled",
              "up-and-down"]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape,size", RESIZES, ids=RESIZE_IDS)
def test_resize_inplane_matches_jax(shape, size, method):
    x = _rand(shape)
    want = np.asarray(KL.resize_inplane(jnp.asarray(x), size, method))
    got = TL.resize_inplane(torch.from_numpy(x), size, method).numpy()
    assert got.shape == want.shape == (*shape[:-3], *size, shape[-1])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resize_inplane_rejects_other_kernels():
    with pytest.raises(ValueError, match="bilinear"):
        TL.resize_inplane(torch.zeros(1, 8, 8, 1), (4, 4), "lanczos3")


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("size", [(1, 2, 2), (2, 1, 1), (2, 3, 2)])
def test_upsample_3d_interpol_matches_jax(size, method):
    x = _rand((2, 3, 5, 6, 2), 1)
    want = np.asarray(KL.upsample_3d_interpol(jnp.asarray(x), size, method))
    got = TL.upsample_3d_interpol(torch.from_numpy(x), size, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [
    {}, {"learnable_scaling": True},
    {"learnable_x": False, "learnable_translation": False},
    {"learnable_y": False, "learnable_z": False}],
    ids=["default", "scaling", "no-x-no-translation", "x-only"])
def test_euler_to_affine_matrix_matches_jax(kw):
    theta = _rand((3, 9), 2)
    want = np.asarray(KL.euler_to_affine_matrix(jnp.asarray(theta), **kw))
    got = TL.euler_to_affine_matrix(torch.from_numpy(theta), **kw).numpy()
    assert got.shape == (3, 12)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_invert_affine_matrix_matches_jax_and_inverts():
    theta = np.array([[0.3, -0.1, 0.7, 5.0, -2.0, 1.0],
                      [-1.2, 0.4, 0.1, 0.0, 3.0, -7.5]], np.float32)
    m = TL.euler_to_affine_matrix(torch.from_numpy(theta))
    got = TL.invert_affine_matrix(m).numpy()
    want = np.asarray(KL.invert_affine_matrix(
        KL.euler_to_affine_matrix(jnp.asarray(theta))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for a, b in zip(m.numpy().reshape(2, 3, 4), got.reshape(2, 3, 4)):
        prod = np.concatenate([a, [[0, 0, 0, 1]]]) @ \
            np.concatenate([b, [[0, 0, 0, 1]]])
        np.testing.assert_allclose(prod, np.eye(4), atol=1e-4)


def test_numpy_helpers_equal_cmrtpus():
    angles = np.array([0.3, -0.2, 0.5])
    np.testing.assert_array_equal(
        TL.euler_angles_to_rotation_matrix(angles),
        KL.euler_angles_to_rotation_matrix(angles))
    m = np.array([1.0, 0.2, 0, 2.0, 0, 1.0, 0.1, -3.0, 0, 0, 1.0, 0.5])
    np.testing.assert_array_equal(TL.affine_matrix_inverter(m),
                                  KL.affine_matrix_inverter(m))


def test_scale_layer_matches_jax():
    x = _rand((2, 3), 3)
    variables = KL.ScaleLayer().init(jax.random.key(0, impl="threefry2x32"),
                                     x)
    assert variables["params"]["scale"].shape == ()
    layer = TL.ScaleLayer()
    assert layer.scale.shape == () and float(layer.scale) == 1.0
    with torch.no_grad():
        layer.scale.fill_(2.5)
    want = np.asarray(KL.ScaleLayer().apply(
        {"params": {"scale": jnp.float32(2.5)}}, x))
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).detach()
                                  .numpy(), want)


@pytest.mark.parametrize("resize", [True, False])
def test_unet_wrapper_matches_jax(resize):
    """The 2D U-Net over z, with the 64² volume resized to its 56² plane
    and back (the 256² -> 224² of a deployment, scaled down)."""
    cfg = {"DIM": [56, 56], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
           "MIXED_PRECISION": False, "GROUP_NORM": 2}
    variables = perturbed_variables(cfg, 0)
    shape = (1, 3, 64, 64, 1) if resize else (1, 3, 56, 56, 1)
    x = _rand(shape, 4)
    wrapper = KL.UnetWrapper(unet=jax_build_model(cfg),
                             unet_inplane=(56, 56), resize=resize)
    want = np.asarray(wrapper.apply({"params": {"unet": variables["params"]}},
                                    x, train=False))
    unet = build_model(cfg)
    unet.load_state_dict(flax_to_state_dict(variables["params"]))
    port = TL.UnetWrapper(unet, unet_inplane=(56, 56), resize=resize).eval()
    assert next(iter(port.state_dict())).startswith("unet.")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (*shape[:-1], 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
