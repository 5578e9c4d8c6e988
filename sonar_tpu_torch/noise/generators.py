"""Noise generators (port of ``sonar_tpu.noise.generators``; reference
py/noise_generation.py). This slice ports the base class and the gaussian and
uniform generators; the rest of the zoo follows in later slices.

Each draw seeds a fresh ``torch.Generator`` on the context's device from the
per-draw seed it is handed, so there is no global RNG state.
"""

from __future__ import annotations

import torch

from ..core.normalize import scale_noise
from ..core.rng import make_generator
from .base import NoiseCtx, NoiseItem


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

    # -- helpers -------------------------------------------------------------
    def randn(self, ctx: NoiseCtx, seed: int, shape=None, dtype=None):
        shape = tuple(shape) if shape is not None else ctx.adjusted_shape()
        return torch.randn(shape, generator=make_generator(seed, ctx.device),
                           dtype=dtype or ctx.dtype, device=ctx.device)

    def rand(self, ctx: NoiseCtx, seed: int, shape=None, dtype=None):
        shape = tuple(shape) if shape is not None else ctx.adjusted_shape()
        return torch.rand(shape, generator=make_generator(seed, ctx.device),
                          dtype=dtype or ctx.dtype, device=ctx.device)

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
