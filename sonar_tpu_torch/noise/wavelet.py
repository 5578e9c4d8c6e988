"""Wavelet noise generators (port of ``sonar_tpu.noise.wavelet``).

- :class:`WaveletGenerator` — per octave, noise minus its down-up-resampled
  self (a band-pass sharpen), accumulated over a persistence-decaying
  amplitude ladder (reference WaveletNoiseGenerator,
  py/noise_generation.py:2196-2327); a negative ``octaves`` walks the
  ladder from its coarse end.
- :class:`WaveletFilteredGenerator` — DWT-decompose noise, optionally blend
  a second "high" noise band by band, scale yl and yh, invert (reference
  WaveletFilteredNoiseGenerator, py/noise_generation.py:1908-2032).
- :class:`WaveletFilteredNoise` — the combinator over that generator with
  inner noise items (py/noise.py:1521-1593).

The ladders are host data computed from the ctx's shape; resizes are
:func:`~..ops.resample.scale_samples`, and the DWT and the dual-tree
transform (``use_dtcwt``) are the port's own (:mod:`..wavelets.dwt`,
:mod:`..wavelets.dtcwt`, exact float32).
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.blend import BLENDING_MODES
from ..core.normalize import scale_noise
from ..core.rng import derive_seed
from ..ops.resample import scale_samples
from ..utils.misc import fallback
from ..wavelets import Wavelet, wavelet_blend, wavelet_scaling
from .base import NoiseCtx, NoiseItem, fix_output_frames
from .generators import Generator


class _Octave(NamedTuple):
    octave: int
    height: int
    width: int
    amplitude: float
    total_amplitude: float


def _resolve_blend(fn_or_name):
    if callable(fn_or_name):
        return fn_or_name
    return BLENDING_MODES[fn_or_name]


class WaveletGenerator(Generator):
    """py/noise_generation.py:2196-2327."""

    name = "wavelet"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "octave_scale_mode": "adaptive_avg_pool2d",
            "octave_rescale_mode": "bilinear",
            "post_octave_rescale_mode": "bilinear",
            "initial_amplitude": 1.0,
            "persistence": 0.5,
            "octaves": 4,
            "octave_height_factor": 0.5,
            "octave_width_factor": 0.5,
            "height_factor": 2.0,
            "width_factor": 2.0,
            "min_height": 4,
            "min_width": 4,
            "update_blend": 1.0,
            "update_blend_function": "lerp",
            "noise_sampler": None,
        }

    def octave_data(self, ctx: NoiseCtx) -> tuple[_Octave, ...]:
        """The octave ladder: each octave's size, amplitude and the running
        total of |amplitude|. Raises where no octave is workable."""
        height, width = ctx.height, ctx.width
        amplitude = self.initial_amplitude
        total = 0.0
        ch, cw = float(height), float(width)
        out = []
        is_reverse = self.octaves < 0
        octaves = range(self.octaves) if not is_reverse else reversed(range(abs(self.octaves)))
        for octave in octaves:
            ch /= self.height_factor**octave
            cw /= self.width_factor**octave
            if (amplitude == 0 or ch < self.min_height or cw < self.min_width
                    or ch * self.octave_height_factor < 1 or cw * self.octave_width_factor < 1):
                if is_reverse and not out:
                    ch, cw = float(height), float(width)
                    continue
                break
            total += abs(amplitude)
            out.append(_Octave(octave, int(ch), int(cw), amplitude, total))
            amplitude *= self.persistence
        if not out or not total:
            raise ValueError("Unworkable parameters for wavelet noise")
        return tuple(out)

    def _max_octave_shape(self, ctx: NoiseCtx):
        od = self.octave_data(ctx)
        b, c = ctx.adjusted_shape()[:2]
        return (b, c, max(o.height for o in od), max(o.width for o in od))

    def init_state(self, ctx, seed):
        if self.noise_sampler is None:
            return ()
        # the inner item draws at the largest octave's size and each octave
        # takes its corner (AdvancedWaveletNoise, py/noise.py:392-443)
        return self.noise_sampler.init_state(ctx.with_shape(self._max_octave_shape(ctx)), seed)

    def _generate_octave(self, ctx, state, seed, sigma, sigma_next, shape):
        h, w = shape[-2:]
        if self.noise_sampler is not None:
            inner_ctx = ctx.with_shape(self._max_octave_shape(ctx))
            full, state = self.noise_sampler.sample(inner_ctx, state, seed, sigma, sigma_next,
                                                    normalized=False)
            noise = full[..., :h, :w].reshape(shape)
        else:
            noise = self.randn(ctx, seed, shape)
        sh = int(max(1, h * self.octave_height_factor))
        sw = int(max(1, w * self.octave_width_factor))
        scaled = scale_samples(scale_samples(noise, sw, sh, mode=self.octave_scale_mode),
                               w, h, mode=self.octave_rescale_mode)
        blend = _resolve_blend(self.update_blend_function)
        return blend(noise, noise - scaled, self.update_blend), state

    def generate(self, ctx, state, seed, sigma, sigma_next):
        shape = ctx.adjusted_shape()
        h, w = shape[-2:]
        result = None
        od = self.octave_data(ctx)
        for i, o in enumerate(od):
            out, state = self._generate_octave(ctx, state, derive_seed(seed, i), sigma,
                                               sigma_next, shape[:-2] + (o.height, o.width))
            if tuple(out.shape) != tuple(shape):
                out = scale_samples(out, w, h, mode=self.post_octave_rescale_mode)
            out = out * o.amplitude
            result = out if result is None else result + out
        if od[-1].total_amplitude != 0:
            result = result / od[-1].total_amplitude
        return fix_output_frames(ctx, result), state


class WaveletFilteredGenerator(Generator):
    """py/noise_generation.py:1908-2032."""

    name = "waveletfilter"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "mode": "periodization",
            "level": 3,
            "wave": "haar",
            "use_1d_dwt": False,
            "use_dtcwt": False,
            "qshift": "qshift_a",
            "biort": "near_sym_a",
            "inv_mode": None,
            "inv_wave": None,
            "yl_scale": 1.0,
            "yh_scales": 1.0,
            "two_step_inverse": False,
            "preblend_yl_scale_low": None,
            "preblend_yh_scales_low": None,
            "preblend_yl_scale_high": None,
            "preblend_yh_scales_high": None,
            "yl_blend_function": "lerp",
            "yh_blend_function": "lerp",
            "yl_blend_high": 0.0,
            "yh_blend_high": 1.0,
            "noise_sampler": None,
            "noise_sampler_high": None,
        }

    def _wavelet(self):
        """The transform, made once (a draw uses it forward, then inverse)."""
        wv = self.__dict__.get("_wv")
        if wv is None:
            wv = self._wv = Wavelet(wave=self.wave, level=self.level, mode=self.mode,
                                    use_1d_dwt=self.use_1d_dwt, use_dtcwt=self.use_dtcwt,
                                    biort=self.biort, qshift=self.qshift,
                                    inv_wave=self.inv_wave, inv_mode=self.inv_mode)
        return wv

    def check_dims(self, ctx):
        super().check_dims(ctx)
        self._wavelet()  # raises for unknown waves and banks

    def init_state(self, ctx, seed):
        cctx = ctx.with_shape(ctx.adjusted_shape())
        return {k: None if item is None else item.init_state(cctx, derive_seed(seed, i))
                for i, (k, item) in enumerate((("low", self.noise_sampler),
                                               ("high", self.noise_sampler_high)))}

    def generate(self, ctx, state, seed, sigma, sigma_next):
        shape = ctx.adjusted_shape()
        cctx = ctx.with_shape(shape)
        slow, shigh = derive_seed(seed, "low"), derive_seed(seed, "high")
        if self.noise_sampler is None:
            noise = self.randn(ctx, slow, shape)
        else:
            noise, st = self.noise_sampler.sample(cctx, state["low"], slow, sigma, sigma_next,
                                                  normalized=False)
            state = {**state, "low": st}
            noise = noise.reshape(shape)
        noise_high = None
        if self.noise_sampler_high is not None:
            noise_high, st = self.noise_sampler_high.sample(cctx, state["high"], shigh, sigma,
                                                            sigma_next, normalized=False)
            state = {**state, "high": st}
            noise_high = noise_high.reshape(shape)
        orig_shape = noise.shape
        wavelet = self._wavelet()
        need_flat = self.use_1d_dwt and noise.ndim > 3
        if need_flat:
            noise = noise.reshape(noise.shape[0], noise.shape[1], -1)
            if noise_high is not None:
                noise_high = noise_high.reshape(noise.shape)
        yl, yh = wavelet.forward(noise)
        if noise_high is not None:
            yl_h, yh_h = wavelet.forward(noise_high)
            if (self.preblend_yl_scale_high is not None
                    or self.preblend_yh_scales_high is not None):
                yl_h, yh_h = wavelet_scaling(yl_h, yh_h,
                                             fallback(self.preblend_yl_scale_high, 1.0),
                                             fallback(self.preblend_yh_scales_high, 1.0))
            if (self.preblend_yl_scale_low is not None
                    or self.preblend_yh_scales_low is not None):
                yl, yh = wavelet_scaling(yl, yh, fallback(self.preblend_yl_scale_low, 1.0),
                                         fallback(self.preblend_yh_scales_low, 1.0))
            yl, yh = wavelet_blend(
                (yl, yh), (yl_h, yh_h), yl_factor=self.yl_blend_high,
                yh_factor=self.yh_blend_high,
                blend_function=_resolve_blend(self.yl_blend_function),
                yh_blend_function=_resolve_blend(self.yh_blend_function))
        yl, yh = wavelet_scaling(yl, yh, self.yl_scale, self.yh_scales)
        result = wavelet.inverse(yl, yh, two_step_inverse=self.two_step_inverse)
        if need_flat:
            result = result.reshape(orig_shape)
        result = fix_output_frames(ctx, result)
        if tuple(result.shape) != tuple(ctx.shape):
            result = result[tuple(slice(0, d) for d in ctx.shape)]
        return result, state


class WaveletFilteredNoise(NoiseItem):
    """The combinator over :class:`WaveletFilteredGenerator` with inner
    noise items (py/noise.py:1521-1593)."""

    MIN_DIMS = 4
    MAX_DIMS = 5
    SHARDABLE = True  # draws a rank's block of a sharded latent (base module docstring)

    def __init__(self, factor=1.0, *, noise=None, noise_high=None, normalize_noise=False,
                 normalize=None, **gen_kwargs):
        super().__init__(factor, normalize=normalize, noise=noise, noise_high=noise_high,
                         normalize_noise=normalize_noise, gen_kwargs=dict(gen_kwargs))
        self._gen = WaveletFilteredGenerator(1.0, noise_sampler=noise,
                                             noise_sampler_high=noise_high, **gen_kwargs)

    def clone(self):
        p = self.cloned_params()
        factor = p.pop("factor")
        kw = p.pop("gen_kwargs")
        return self.__class__(factor, **p, **kw)

    def check_dims(self, ctx):
        self._gen.check_dims(ctx)

    def init_state(self, ctx, seed):
        return self._gen.init_state(ctx, seed)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.normalize if self.normalize is not None else normalized
        noise, state = self._gen.generate(ctx, state, seed, sigma, sigma_next)
        return scale_noise(noise, self.factor, normalized=bool(normalize),
                           shard=ctx.shard), state


__all__ = ["WaveletFilteredGenerator", "WaveletFilteredNoise", "WaveletGenerator"]
