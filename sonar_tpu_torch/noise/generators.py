"""Noise generators (port of ``sonar_tpu.noise.generators``; reference
py/noise_generation.py). Ported so far: the base class, gaussian, uniform,
brownian, the pyramid family (``highres_pyramid``, ``pyramid_old``,
``pyramid``) and ``mixed``; the rest of the zoo follows in later slices.

Every draw goes through the Philox stream of :mod:`..kernels.hwrng` (kernel
B3 on the card, its plain version on the CPU), seeded from the per-draw
seed it is handed, so there is no global RNG state and one seed gives the
same noise on both devices. Sub-draws take seeds from
:func:`~sonar_tpu_torch.core.rng.derive_seed`, as the JAX package folds keys.

The pyramids take their kernel (B4 or B5) whenever its gate, a pure
function of the configuration, holds (``*_supported`` in
:mod:`..kernels.fused_pyramid`); on a CPU tensor the kernel's wrapper runs
its plain version. Otherwise they take the composed path, Philox levels
through :func:`~sonar_tpu_torch.ops.resample.scale_samples`, as the JAX
package does with threefry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.normalize import scale_noise
from ..core.rng import derive_seed
from ..kernels.fused_pyramid import (
    fused_downscale_pyramid,
    fused_downscale_supported,
    fused_pyramid,
    fused_pyramid_supported,
)
from ..kernels.hwrng import philox_rand, philox_randn
from ..ops.resample import scale_samples
from ..utils.misc import default_device
from .base import NoiseCtx, NoiseItem, fix_output_frames
from .brownian import endpoint_increment, endpoint_state


def _device(ctx: NoiseCtx) -> torch.device:
    """The context's device; one that names none runs on the card."""
    return default_device(ctx.device)


class Generator(NoiseItem):
    """Leaf noise generator spec.

    Config fields: algorithm params (see ``ng_params``) plus
    ``gen_normalized`` (tri-state internal output_hook control),
    ``force_normalize``, ``normalize_dims`` — py/noise_generation.py:110-118.
    """

    name = "unknown"
    DEFAULT_NORMALIZED = True  # class default for the internal output hook
    MIN_DIMS = 1
    MAX_DIMS = 0

    def __init__(self, factor: float = 1.0, *, normalize: bool | None = None, **kwargs):
        merged = dict(self.ng_params())
        extra = {k: v for k, v in kwargs.items() if k not in merged}
        merged.update({k: v for k, v in kwargs.items() if k in merged})
        super().__init__(factor, normalize=normalize, **merged)
        self.options = extra
        self._keys = (*self._keys, "options")

    @classmethod
    def ng_params(cls) -> dict:
        return {
            "gen_normalized": None,
            "force_normalize": None,
            "normalize_dims": None,
        }

    def clone(self):
        p = self.cloned_params()
        factor = p.pop("factor")
        opts = p.pop("options", {})
        return self.__class__(factor, **p, **opts)

    # -- helpers -------------------------------------------------------------
    def randn(self, ctx: NoiseCtx, seed: int, shape=None, dtype=None):
        shape = tuple(shape) if shape is not None else ctx.adjusted_shape()
        return philox_randn(seed, shape, device=_device(ctx), dtype=dtype or ctx.dtype)

    def rand(self, ctx: NoiseCtx, seed: int, shape=None, dtype=None):
        shape = tuple(shape) if shape is not None else ctx.adjusted_shape()
        return philox_rand(seed, shape, device=_device(ctx), dtype=dtype or ctx.dtype)

    # -- protocol ------------------------------------------------------------
    def generate(self, ctx: NoiseCtx, state, seed, sigma, sigma_next):
        raise NotImplementedError

    def output_hook(self, noise, *, internal_default: bool):
        gen_norm = (
            self.gen_normalized if self.gen_normalized is not None else internal_default
        )
        return scale_noise(
            noise,
            normalized=bool(gen_norm)
            and (self.force_normalize is None or self.force_normalize is True),
            normalize_dims=self.normalize_dims,
        )

    def hooked(self, ctx, state, seed, sigma, sigma_next, *, internal_default=None):
        """Nested-generator entry point: class-default internal hook."""
        d = self.DEFAULT_NORMALIZED if internal_default is None else internal_default
        noise, state = self.generate(ctx, state, seed, sigma, sigma_next)
        return self.output_hook(noise, internal_default=d), state

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        # Item-layer path: internal hook off (py/noise.py:220-231), one
        # scale_noise with the factor at this level (py/noise.py:249-257).
        noise, state = self.hooked(ctx, state, seed, sigma, sigma_next,
                                   internal_default=False)
        noise = self.apply_factor_normalize(noise, normalized=normalized)
        return noise.to(ctx.dtype), state


class GaussianGenerator(Generator):
    """py/noise_generation.py:252-260."""

    name = "gaussian"
    DEFAULT_NORMALIZED = False

    def generate(self, ctx, state, seed, sigma, sigma_next):
        return self.randn(ctx, seed, shape=ctx.shape), state


class UniformGenerator(Generator):
    """(rand - sub_fac) * mul_fac + mean_fac (py/noise_generation.py:496-514)."""

    name = "uniform"
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"sub_fac": 0.5, "mul_fac": 3.46, "mean_fac": 0.0}

    def generate(self, ctx, state, seed, sigma, sigma_next):
        n = self.rand(ctx, seed, shape=ctx.shape)
        return (n - self.sub_fac) * self.mul_fac + self.mean_fac, state


class BrownianGenerator(Generator):
    """Brownian-tree-style sigma-correlated noise (py/noise_generation.py:263-286).

    The only sigma-consuming base generator. The state carries the seed of
    the bridge chosen at init, so every (sigma, sigma_next) query addresses
    the same underlying Brownian path, and the last endpoint."""

    name = "brownian"
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"levels": 16}

    def init_state(self, ctx, seed):
        return endpoint_state(ctx, seed)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        del seed  # path identity comes from the init-time seed
        return endpoint_increment(ctx, state, sigma, sigma_next, levels=self.levels)


def _size_ladder_highres(h: int, w: int, iterations: int, schedule_seed: int):
    """Build-time random resize ladder for highres_pyramid
    (py/noise_generation.py:544-555): r ~ U[2,4) per iter, sizes grow as
    h*(r^i) capped at 15x; stop after the cap is hit."""
    rng = np.random.default_rng(schedule_seed)
    rs = rng.random(iterations) * 2 + 2
    sizes = []
    ch, cw = h, w
    for i in range(iterations):
        r = float(rs[i])
        ch, cw = min(h * 15, int(ch * (r**i))), min(w * 15, int(cw * (r**i)))
        sizes.append((ch, cw))
        if ch >= h * 15 or cw >= w * 15:
            break
    return sizes


def _size_ladder_pyramid(h: int, w: int, iterations: int, schedule_seed: int):
    """Build-time ladder for pyramid (py/noise_generation.py:626-648):
    sizes shrink as max(1, size/(r^i)); stop at 1."""
    rng = np.random.default_rng(schedule_seed)
    sizes = []
    ch, cw = h, w
    for i in range(iterations):
        r = float(rng.random(1)[0] * 2 + 2)
        cw, ch = max(1, int(cw / (r**i))), max(1, int(ch / (r**i)))
        sizes.append((ch, cw))
        if cw == 1 or ch == 1:
            break
    return sizes


class HighresPyramidGenerator(Generator):
    """py/noise_generation.py:517-564: an inner base (uniform by default)
    plus ever larger gaussian levels, each downscaled to the latent."""

    name = "highres_pyramid"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "discount": 0.7,
            "upscale_mode": "bilinear",
            "iterations": 4,
            "noise_generator": None,
            "normalize_noise": False,
            "schedule_seed": 0,
        }

    def _inner(self):
        if self.noise_generator is not None:
            return self.noise_generator
        return UniformGenerator(gen_normalized=self.normalize_noise)

    def init_state(self, ctx, seed):
        return self._inner().init_state(ctx, seed)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b, c, h, w = ctx.adjusted_shape()
        base, state = self._inner().hooked(ctx, state, derive_seed(seed, "inner"),
                                           sigma, sigma_next)
        noise = base.reshape(b, c, h, w)
        sizes = _size_ladder_highres(h, w, self.iterations, self.schedule_seed)
        draw = derive_seed(seed, "draw")
        if fused_downscale_supported(sizes, h, w, self.upscale_mode):
            # levels >= 2x the output per axis: only their tapped samples
            # are drawn (kernel B5), the oversized levels never exist
            coefs = [self.discount**i for i in range(len(sizes))]
            noise = fused_downscale_pyramid(draw, (b, c, h, w), sizes, coefs,
                                            self.upscale_mode, base=noise)
            return fix_output_frames(ctx, noise), state
        for i, (sh, sw) in enumerate(sizes):
            big = self.randn(ctx, derive_seed(draw, i), (b, c, sh, sw), noise.dtype)
            noise = noise + scale_samples(big, w, h, mode=self.upscale_mode) * (
                self.discount**i)
        return fix_output_frames(ctx, noise), state


class PyramidOldGenerator(Generator):
    """Deterministic 2^i upscale ladder, std 0.5^i, nearest-exact downscale
    (py/noise_generation.py:567-606). 'Generates noise ~60x the latent
    size'; kernel B5 draws only the samples the downscale taps."""

    name = "pyramid_old"
    MIN_DIMS = 4
    MAX_DIMS = 5
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "discount": 0.8,
            "iterations": 5,
            "upscale_mode": "nearest-exact",
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b, c, h, w = ctx.adjusted_shape()
        sizes = [(h * 2 ** (i + 1), w * 2 ** (i + 1)) for i in range(self.iterations)]
        if fused_downscale_supported(sizes, h, w, self.upscale_mode):
            coefs = [(0.5**i) * self.discount**i for i in range(self.iterations)]
            noise = fused_downscale_pyramid(seed, (b, c, h, w), sizes, coefs,
                                            self.upscale_mode, device=_device(ctx))
            return fix_output_frames(ctx, noise), state
        noise = torch.zeros((b, c, h, w), dtype=ctx.dtype, device=_device(ctx))
        for i, (sh, sw) in enumerate(sizes):
            big = self.randn(ctx, derive_seed(seed, i), (b, c, sh, sw)) * (0.5**i)
            noise = noise + scale_samples(big, w, h, mode=self.upscale_mode) * (
                self.discount**i)
        return fix_output_frames(ctx, noise), state


class PyramidGenerator(Generator):
    """Whitaker multi-resolution noise (py/noise_generation.py:609-649)."""

    name = "pyramid"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "discount": 0.7,
            "upscale_mode": "bilinear",
            "iterations": 10,
            "schedule_seed": 0,
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b, c, h, w = ctx.adjusted_shape()
        sizes = _size_ladder_pyramid(h, w, self.iterations, self.schedule_seed)
        if fused_pyramid_supported(sizes, h, w, self.upscale_mode):
            noise = fused_pyramid(seed, (b, c, h, w), sizes, self.discount,
                                  self.upscale_mode, device=_device(ctx))
            return fix_output_frames(ctx, noise), state
        noise = self.randn(ctx, derive_seed(seed, "base"), (b, c, h, w))
        for i, (sh, sw) in enumerate(sizes):
            small = self.randn(ctx, derive_seed(seed, "draw", i), (b, c, sh, sw))
            noise = noise + scale_samples(small, w, h, mode=self.upscale_mode) * (
                self.discount**i)
        return fix_output_frames(ctx, noise), state


class MixedGenerator(Generator):
    """Sum of member generators with optional transforms and an output fn
    (py/noise_generation.py:212-249). Members keep their class-default
    internal normalization."""

    name = "mixed"

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "mix_name": "mixed_noise",
            "noise_mix": (),
            "output_fun": None,
        }

    def _members(self):
        out = []
        for item in self.noise_mix:
            gen, transform = (item, None) if isinstance(item, Generator) else item
            out.append((gen, transform))
        return out

    def check_dims(self, ctx):
        for gen, _t in self._members():
            gen.check_dims(ctx)

    def init_state(self, ctx, seed):
        return tuple(gen.init_state(ctx, derive_seed(seed, i))
                     for i, (gen, _t) in enumerate(self._members()))

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = None
        new_states = []
        for i, (gen, transform) in enumerate(self._members()):
            n, st = gen.hooked(ctx, state[i], derive_seed(seed, i), sigma, sigma_next)
            new_states.append(st)
            if transform is not None:
                n = transform(n) if callable(transform) else n * transform
            noise = n if noise is None else noise + n
        if self.output_fun is not None:
            out = self.output_fun
            noise = out(noise) if callable(out) else noise * out
        return noise, tuple(new_states)
