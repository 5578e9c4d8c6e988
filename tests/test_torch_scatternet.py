"""The port's scatternet noise (``noise/scatternet.py``) against the JAX
package's, on the CPU.

The four scattering layers on one numpy input, then the generator and the
combinator over a stub noise child (``tests/_combinator_stubs.py``) or, with
no child, on shared numpy normals (the JAX module's ``jax.random.normal``
and the port's Philox normals replaced by one table): every
``output_mode``, orders {0, 1, 2, −2, 3}, the per-channel mode, both
backends, symmetric filters, and fractional, negative and whole
``output_offset``. Tolerance 1e-5 relative to max(1, |JAX|): the port's
exact float32 product-sums against XLA's convolutions, and the biased
magnitudes' square roots.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.scatternet as JS
import sonar_tpu_torch.noise.generators as TG
import sonar_tpu_torch.noise.scatternet as TS
from _combinator_stubs import close_rel, run_both, stubs
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu_torch.noise import NoiseCtx

MODES = ["channels", "channels_adjusted", "channels_scaled", "flat", "flat_adjusted",
         "flat_scaled"]


@pytest.fixture(autouse=True)
def _quiet_substitutions():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layer,kw", [
    ("scat_layer_dwt", {}), ("scat_layer_dwt", {"wave": "db4", "mode": "periodization"}),
    ("scat_layer_dtcwt", {}), ("scat_layer_dtcwt", {"biort": "near_sym_b", "qshift": "qshift_b",
                                                    "magbias": 0.1}),
    ("scat_layer_j2", {}), ("scat_layer_j2_dwt", {"wave": "haar"}),
])
def test_layers_match_jax(layer, kw):
    x = _x((1, 2, 16, 16))
    want = np.asarray(getattr(JS, layer)(jnp.asarray(x), **kw))
    got = getattr(TS, layer)(torch.from_numpy(x), **kw)
    mult = {"scat_layer_dwt": 4, "scat_layer_dtcwt": 7, "scat_layer_j2": 49,
            "scat_layer_j2_dwt": 16}[layer]
    assert got.shape[1] == 2 * mult
    close_rel(got, want)


@pytest.fixture
def normals(monkeypatch):
    rng = np.random.default_rng(4)
    table = {}

    def take(shape):
        shape = tuple(shape)
        if shape not in table:
            table[shape] = rng.standard_normal(shape).astype(np.float32)
        return table[shape]

    class _Random:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        def normal(self, key, shape=(), dtype=jnp.float32):
            return jnp.asarray(take(shape), dtype)

    monkeypatch.setattr(JS, "jax", type("FakeJax", (), {
        "random": _Random(), "__getattr__": lambda s, n: getattr(jax, n)})())
    monkeypatch.setattr(TG, "philox_randn", lambda seed, shape, *, device, dtype, stream=0:
                        torch.from_numpy(take(shape).copy()).to(device=device, dtype=dtype))


def _generate(kw, shape):
    want, _ = JS.ScatternetFilteredGenerator(**kw).generate(
        JCtx(shape), (), jax.random.key(0), 1.0, 0.5)
    got, _ = TS.ScatternetFilteredGenerator(**kw).generate(
        NoiseCtx(shape, device="cpu"), (), 0, 1.0, 0.5)
    close_rel(got, np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ["dtcwt", "dwt"])
def test_generator_every_output_mode_matches_jax(mode, backend, normals):
    _generate({"output_mode": mode, "wavelet_backend": backend}, (1, 2, 8, 8))


@pytest.mark.parametrize("order,backend", [(0, "dtcwt"), (2, "dtcwt"), (-2, "dtcwt"),
                                           (3, "dtcwt"), (2, "dwt"), (-2, "dwt")])
def test_generator_orders_match_jax(order, backend, normals):
    _generate({"scatternet_order": order, "wavelet_backend": backend,
               "output_mode": "channels_adjusted" if order != 3 else "flat"}, (1, 2, 8, 8))


@pytest.mark.parametrize("offset", [0.3, -0.4, -1, -2, 2, 0.999])
@pytest.mark.parametrize("per_channel", [False, True])
def test_output_offset_and_per_channel_match_jax(offset, per_channel, normals):
    _generate({"output_offset": offset, "per_channel_scatternet": per_channel,
               "output_mode": "channels_adjusted"}, (1, 3, 8, 8))


@pytest.mark.parametrize("mode", ["flat", "flat_scaled", "channels"])
def test_per_channel_flat_and_symmetric_filter_match_jax(mode, normals):
    _generate({"per_channel_scatternet": True, "output_mode": mode,
               "use_symmetric_filter": True, "output_offset": -0.5}, (1, 2, 8, 8))


@pytest.mark.parametrize("kw", [
    {},  # the defaults: dtcwt, order 1, channels_adjusted
    {"wavelet_backend": "dwt", "scatternet_order": 2, "output_mode": "flat_adjusted"},
    {"scatternet_order": -2, "output_mode": "channels_scaled", "upscale_mode": "nearest-exact",
     "output_offset": 0.5},
])
def test_noise_over_a_stub_child_matches_jax(kw):
    (j,), (t,) = stubs("scat")
    run_both(JS.ScatternetFilteredNoise(noise=j, **kw), TS.ScatternetFilteredNoise(noise=t, **kw),
             (1, 2, 16, 16), n=2)


def test_bad_output_mode_and_clone():
    with pytest.raises(ValueError, match="Bad output mode"):
        TS.ScatternetFilteredGenerator(output_mode="nope").init_state(
            NoiseCtx((1, 2, 8, 8), device="cpu"), 0)
    (t,) = stubs("scat")[1]
    c = TS.ScatternetFilteredNoise(noise=t, padding_mode="zero", scatternet_order=2).clone()
    assert c.gen_kwargs == {"scatternet_order": 2} and c.padding_mode == "zero"
    assert TS.ScatternetFilteredGenerator.ng_params() == JS.ScatternetFilteredGenerator.ng_params()
