"""The port's wavelet noise (``noise/wavelet.py``) against the JAX package's,
on the CPU: the octave ladders (negative octaves and the "unworkable"
error included), ``WaveletGenerator`` and ``WaveletFilteredGenerator`` on
shared numpy normals (the JAX module's ``jax.random.normal`` and the port's
Philox normals both replaced by one table read in call order), the
combinator over stub children (``tests/_combinator_stubs.py``), the 1D DWT
path, and the ``"wavelet"`` registry name. Tolerance 1e-5 relative to
max(1, |JAX|) (resize products and DWT sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.presets as JP
import sonar_tpu.noise.wavelet as JW
import sonar_tpu_torch.noise.generators as TG
import sonar_tpu_torch.noise.presets as TP
import sonar_tpu_torch.noise.wavelet as TW
from _combinator_stubs import close_rel, run_both, stubs
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu_torch.noise import NoiseCtx, make_noise_sampler


class _Normals:
    def __init__(self):
        self.rng, self.draws, self.pos = np.random.default_rng(9), [], {"jax": 0, "torch": 0}

    def take(self, side, shape):
        i = self.pos[side]
        self.pos[side] += 1
        while len(self.draws) <= i:
            self.draws.append(None)
        if self.draws[i] is None:
            self.draws[i] = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        assert self.draws[i].shape == tuple(shape)
        return self.draws[i]


@pytest.fixture
def normals(monkeypatch):
    nm = _Normals()

    class FakeRandom:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        def split(self, key, num=2):
            return [key] * num

        def fold_in(self, key, data):
            return key

        def normal(self, key, shape=(), dtype=jnp.float32):
            return jnp.asarray(nm.take("jax", shape), dtype)

    class FakeJax:
        random = FakeRandom()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(JW, "jax", FakeJax())
    monkeypatch.setattr(TG, "philox_randn", lambda seed, shape, *, device, dtype=torch.float32,
                        stream=0: torch.from_numpy(nm.take("torch", shape).copy()).to(
                            device=device, dtype=dtype))
    return nm


LADDERS = [
    {},
    {"octaves": 6, "persistence": 0.7, "min_height": 2, "min_width": 2},
    {"octaves": -4},
    {"octaves": -6, "height_factor": 1.5, "width_factor": 1.25},
    {"octaves": 3, "initial_amplitude": -1.0, "octave_height_factor": 0.25},
    {"octaves": 5, "persistence": 0.0},
]


@pytest.mark.parametrize("kw", LADDERS)
@pytest.mark.parametrize("hw", [(64, 48), (17, 33)])
def test_octave_ladders(kw, hw):
    shape = (1, 4) + hw
    want = JW.WaveletGenerator(**kw).octave_data(JCtx(shape=shape))
    got = TW.WaveletGenerator(**kw).octave_data(NoiseCtx(shape=shape, device="cpu"))
    assert [tuple(o) for o in got] == [tuple(o) for o in want]


@pytest.mark.parametrize("kw", [{"min_height": 100}, {"initial_amplitude": 0.0},
                                {"octaves": -3, "min_width": 99}])
def test_unworkable_ladders_raise(kw):
    with pytest.raises(ValueError, match="Unworkable"):
        JW.WaveletGenerator(**kw).octave_data(JCtx(shape=(1, 4, 32, 32)))
    with pytest.raises(ValueError, match="Unworkable"):
        TW.WaveletGenerator(**kw).octave_data(NoiseCtx(shape=(1, 4, 32, 32), device="cpu"))


def _generate_pair(jgen, tgen, shape):
    jctx, tctx = JCtx(shape=shape), NoiseCtx(shape=shape, device="cpu")
    want, _ = jgen.hooked(jctx, jgen.init_state(jctx, jax.random.key(0)), jax.random.key(1),
                          jnp.float32(1.0), jnp.float32(0.5))
    got, _ = tgen.hooked(tctx, tgen.init_state(tctx, 0), 1, 1.0, 0.5)
    return got, want


@pytest.mark.parametrize("kw", [
    {},
    {"octaves": -4, "update_blend": 0.6, "octave_scale_mode": "bilinear",
     "post_octave_rescale_mode": "bicubic"},
    {"octaves": 3, "update_blend_function": "inject", "gen_normalized": False},
])
@pytest.mark.parametrize("shape", [(2, 3, 32, 24), (1, 2, 3, 16, 16)])
def test_wavelet_generator(kw, shape, normals):
    got, want = _generate_pair(JW.WaveletGenerator(**kw), TW.WaveletGenerator(**kw), shape)
    assert normals.pos["jax"] == normals.pos["torch"] > 0
    close_rel(got, want)


def test_wavelet_generator_over_an_inner_item():
    js, ts = stubs("inner")
    run_both(JW.WaveletGenerator(noise_sampler=js[0], octaves=3),
             TW.WaveletGenerator(noise_sampler=ts[0], octaves=3), (1, 4, 32, 32), n=3)


@pytest.mark.parametrize("kw", [
    {},
    {"wave": "db4", "level": 2, "mode": "symmetric", "yl_scale": 0.5, "yh_scales": (1.2, 0.7)},
    {"wave": "sym3", "mode": "symmetric", "two_step_inverse": True, "inv_mode": "zero",
     "yh_scales": 1.5},
    {"wave": "sym3", "two_step_inverse": True, "inv_mode": "zero"},
    {"use_1d_dwt": True, "wave": "db2", "level": 4},
])
def test_wavelet_filtered_generator(kw, normals):
    got, want = _generate_pair(JW.WaveletFilteredGenerator(**kw),
                               TW.WaveletFilteredGenerator(**kw), (2, 4, 16, 24))
    close_rel(got, want)


@pytest.mark.parametrize("kw", [
    {"wave": "db4", "level": 3},
    {"wave": "haar", "yl_blend_high": 0.3, "yh_blend_high": 0.8,
     "preblend_yl_scale_high": 0.5, "preblend_yh_scales_low": 2.0,
     "yh_blend_function": "inject"},
    {"use_1d_dwt": True, "wave": "db3", "level": 2, "yh_scales": 0.5},
])
@pytest.mark.parametrize("high", [True, False])
def test_wavelet_filtered_noise(kw, high):
    (jl, jh), (tl, th) = stubs("low", "high")
    run_both(JW.WaveletFilteredNoise(noise=jl, noise_high=jh if high else None, **kw),
             TW.WaveletFilteredNoise(noise=tl, noise_high=th if high else None, **kw),
             (1, 4, 24, 16), n=3)


def test_wavelet_filtered_noise_5d_and_clone():
    (jl,), (tl,) = stubs("low5")
    run_both(JW.WaveletFilteredNoise(noise=jl, wave="db2", level=2),
             TW.WaveletFilteredNoise(noise=tl, wave="db2", level=2), (1, 2, 3, 16, 16), n=2)
    c = TW.WaveletFilteredNoise(noise=tl, wave="db2", level=2).clone()
    assert c.gen_kwargs == {"wave": "db2", "level": 2}


def test_dtcwt_raises_instead_of_being_ignored():
    """Once a pin of the refusal of ``use_dtcwt``; the dual tree is ported
    now, so this holds the filtered noise over it against the JAX package's
    (unknown banks still raise, at the sampler's set-up)."""
    (jx,), (tx,) = stubs("x")
    run_both(JW.WaveletFilteredNoise(noise=jx, use_dtcwt=True, level=2),
             TW.WaveletFilteredNoise(noise=tx, use_dtcwt=True, level=2), (1, 4, 16, 16), n=2)
    with pytest.raises(ValueError, match="Unknown qshift"):
        make_noise_sampler(TW.WaveletFilteredNoise(noise=tx, use_dtcwt=True, qshift="db4"),
                           (1, 4, 16, 16), device="cpu")


def test_wavelet_registry_name(normals):
    got, want = _generate_pair(JP.get_noise_item("wavelet"), TP.get_noise_item("wavelet"),
                               (1, 4, 64, 64))
    close_rel(got, want)
    names = set(TP.noise_type_names())
    assert "wavelet" in names and len(names) == 38
    assert set(JP.noise_type_names()) == names
