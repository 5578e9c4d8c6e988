"""The port's core layer against the JAX package: scale_noise in every
branch and in per-dims mode, tstd, the eleven blend modes, and the
counter-based seed derivation. Same numpy inputs through both; tolerance
1e-6 absolute (scaled by the magnitude where it exceeds 1) — this is
elementwise code and single reductions."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonar_tpu.core.normalize import scale_noise as j_scale_noise, tstd as j_tstd
from sonar_tpu_torch.core.normalize import scale_noise, tstd
from sonar_tpu_torch.core.rng import derive_seed, make_generator, seed_from

ATOL = 1e-6
# the packages re-export a function named ``blend`` over the module's name
jblend = importlib.import_module("sonar_tpu.core.blend")
tblend = importlib.import_module("sonar_tpu_torch.core.blend")


def _close(a, b, atol=ATOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= atol * scale


def _x(shape=(2, 4, 8, 8), seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("scale,shift,factor", [
    (1.0, 0.0, 1.0), (1.0, 0.7, 1.0), (2.5, 0.0, 1.0), (0.3, -1.2, 1.0),
    (2.0, 0.5, 0.5), (0.0, 0.0, 1.0), (0.0, 3.0, 2.0),
])
def test_scale_noise_global_branches(scale, shift, factor):
    x = _x(scale=scale, shift=shift)
    ref = j_scale_noise(jnp.asarray(x), factor)
    out = scale_noise(torch.from_numpy(x), factor)
    _close(out.numpy(), ref)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("dims", [(-2, -1), (-3, -2, -1), (1,)])
@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_scale_noise_per_dims(dims, factor):
    x = _x(scale=2.0, shift=0.4)
    x[0, 1] = 3.0  # one constant plane: the zero-std guard
    ref = j_scale_noise(jnp.asarray(x), factor, normalize_dims=dims)
    out = scale_noise(torch.from_numpy(x), factor, normalize_dims=dims)
    _close(out.numpy(), ref)


def test_scale_noise_off_and_empty():
    x = _x(scale=3.0)
    np.testing.assert_array_equal(scale_noise(torch.from_numpy(x), 2.0, normalized=False).numpy(),
                                  x * np.float32(2.0))
    empty = torch.zeros((0, 4))
    assert scale_noise(empty).shape == (0, 4)


@pytest.mark.parametrize("dim", [None, (-2, -1), 1])
def test_tstd_is_ddof1(dim):
    x = _x(scale=1.7, shift=0.2)
    _close(tstd(torch.from_numpy(x), dim=dim).numpy(), j_tstd(jnp.asarray(x), axis=dim))


@pytest.mark.parametrize("name", sorted(jblend.BLENDING_MODES))
@pytest.mark.parametrize("t", [0.3, 0.95])
def test_blend_modes_match_jax(name, t):
    a, b = _x(seed=1), _x(seed=2, scale=2.0)
    ref = jblend.BLENDING_MODES[name](jnp.asarray(a), jnp.asarray(b), t)
    out = tblend.BLENDING_MODES[name](torch.from_numpy(a), torch.from_numpy(b), t)
    _close(out.numpy(), ref, atol=2e-6 if name == "slerp" else ATOL)


def test_blend_registry_is_complete_and_errors():
    assert set(tblend.BLENDING_MODES) == set(jblend.BLENDING_MODES)
    assert len(tblend.BLENDING_MODES) == 11
    with pytest.raises(ValueError, match="Unknown blend mode"):
        tblend.blend("nope")


def test_seed_derivation_is_a_pure_function_of_the_path():
    s = seed_from(7)
    assert derive_seed(s, "noise") == derive_seed(seed_from(7), "noise")
    labels = {derive_seed(s, p) for p in ("noise", "init", "rand_init", 0, 1, 2)}
    assert len(labels) == 6
    assert derive_seed(s, "noise", 3) != derive_seed(s, "noise", 4)
    assert seed_from(None) == seed_from(0) != seed_from(1)
    assert seed_from(2**40 + 5) != seed_from(5)  # high bits count
    a = torch.randn(16, generator=make_generator(derive_seed(s, "noise", 0)))
    b = torch.randn(16, generator=make_generator(derive_seed(s, "noise", 0)))
    assert torch.equal(a, b)
