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


# ---------------------------------------------------------------------------
# tap tables: the sparse rows of the interpolation matrices (kernel B4's input)
# ---------------------------------------------------------------------------

# (in, out) pairs of the 64 -> 25 -> 5 -> 1 and 512 -> 201 -> 46 ladders, of the
# ragged 67 x 61 ladder, and sizes whose bicubic edge taps clamp onto each other
TAP_SIZES = [(25, 64), (5, 64), (1, 64), (201, 512), (46, 512), (5, 512), (1, 512),
             (26, 67), (23, 61), (5, 61), (2, 7), (3, 61), (64, 64), (61, 61)]
TAP_MODES = ("bilinear", "bicubic", "nearest", "nearest-exact", "area")


@pytest.mark.parametrize("mode", TAP_MODES)
@pytest.mark.parametrize("sizes", TAP_SIZES)
def test_tap_tables_are_the_matrix(mode, sizes):
    """Densified, the tables are ``_resize_matrix`` byte for byte; columns
    ascend, padding weighs 0, and no upscaling row has more than 4 taps."""
    i, o = sizes
    dense = TR._resize_matrix(i, o, mode)
    idx, val = TR._resize_taps(i, o, mode)
    assert idx.dtype == np.int32 and val.dtype == np.float32
    assert idx.shape == val.shape == (o, idx.shape[1]) and 1 <= idx.shape[1] <= 4
    assert idx.shape[1] == max(1, int((dense != 0).sum(axis=1).max()))
    assert idx.min() >= 0 and idx.max() < i and (np.diff(idx, axis=1) >= 0).all()
    back = np.zeros_like(dense)
    np.add.at(back, (np.arange(o)[:, None], idx), val)
    assert back.tobytes() == dense.tobytes()
    # a padding tap repeats the row's last column with weight exactly 0
    pad = np.arange(idx.shape[1])[None, :] >= (dense != 0).sum(axis=1)[:, None]
    assert (val[pad] == 0).all() and (val[~pad] != 0).all()


def test_tap_tables_are_cached_per_device():
    a = TR.resize_taps(5, 16, "bicubic", device="cpu")
    assert a is TR.resize_taps(5, 16, "bicubic", device=torch.device("cpu"))
    idx, val = a
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    assert idx.is_contiguous() and val.is_contiguous() and idx.shape == (16, 4)
    want = torch.from_numpy(TR._resize_matrix(5, 16, "bicubic"))
    got = torch.zeros(16, 5).index_put_((torch.arange(16)[:, None], idx.long()), val,
                                        accumulate=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", TAP_MODES)
@pytest.mark.parametrize("sizes", [(25, 64), (1, 64), (2, 7), (3, 61)])
def test_tap_tables_pad_to_a_calls_width(mode, sizes):
    """One B4 call uses one width (1, 2 or 4) for all its levels: a table
    padded beyond its own width still is the matrix, its padding repeats the
    last column with weight 0, and a width below the matrix's own raises."""
    i, o = sizes
    own = TR._resize_taps(i, o, mode)[0].shape[1]
    idx, val = TR._resize_taps(i, o, mode, 4)
    assert idx.shape == val.shape == (o, 4) and (np.diff(idx, axis=1) >= 0).all()
    assert idx.min() >= 0 and idx.max() < i and (val[:, own:] == 0).all()
    back = np.zeros((o, i), np.float32)
    np.add.at(back, (np.arange(o)[:, None], idx), val)
    assert back.tobytes() == TR._resize_matrix(i, o, mode).tobytes()
    if own > 1:
        with pytest.raises(ValueError, match="taps"):
            TR._resize_taps(i, o, mode, own - 1)
