"""ops/resample.py against the JAX package on the same numpy inputs.

``_resize_matrix`` is the same numpy code on both sides and must be equal
exactly; ``scale_samples`` is held to 1e-5 absolute (float32 products
summed in another order; bislerp's arccos/sin in float32).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.ops.resample as JR
import sonar_tpu_torch.ops.resample as TR

SEPARABLE = ("bilinear", "nearest-exact", "nearest", "area", "bicubic",
             "adaptive_avg_pool2d")
SIZES = (1, 2, 3, 5, 7, 8, 16, 25, 33, 64)


def test_upscale_methods_match():
    assert TR.UPSCALE_METHODS == JR.UPSCALE_METHODS


@pytest.mark.parametrize("mode", SEPARABLE)
def test_resize_matrix_equals_jax(mode):
    for i, o in itertools.product(SIZES, SIZES):
        got = TR._resize_matrix(i, o, mode)
        assert got.dtype == np.float32 and got.shape == (o, i)
        np.testing.assert_array_equal(got, JR._resize_matrix(i, o, mode))
    with pytest.raises(ValueError):
        TR._resize_matrix(4, 8, "lanczos")


def test_resize_matrix_device_tensors_are_cached():
    a = TR.resize_matrix(5, 16, "bilinear", device="cpu")
    assert a is TR.resize_matrix(5, 16, "bilinear", device=torch.device("cpu"))
    t = TR.resize_matrix(5, 16, "bilinear", device="cpu", transpose=True)
    assert t.shape == (5, 16) and t.is_contiguous() and torch.equal(t, a.T)


@pytest.mark.parametrize("mode", TR.UPSCALE_METHODS)
@pytest.mark.parametrize("hw,out", [((8, 12), (20, 17)), ((20, 17), (6, 9)),
                                    ((7, 7), (7, 30)), ((16, 16), (16, 16))])
def test_scale_samples_matches_jax(mode, hw, out):
    x = np.random.default_rng(3).standard_normal((2, 4, *hw)).astype(np.float32)
    want = JR.scale_samples(jnp.asarray(x), out[1], out[0], mode=mode)
    got = TR.scale_samples(torch.from_numpy(x), out[1], out[0], mode=mode)
    assert tuple(got.shape) == (2, 4, *out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
