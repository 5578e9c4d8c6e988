"""Leaf noise items (port of ``sonar_tpu.noise.items``): the typed-noise
equivalent of ``CustomNoiseItem`` (py/noise.py:83-134), with the
``override_sigma*`` escape hatches that let sigma-dependent generators work
outside sampling."""

from __future__ import annotations

import dataclasses

from ..utils.misc import fallback
from .base import NoiseCtx, NoiseItem


class TypedNoiseItem(NoiseItem):
    """Wraps a named noise type from the preset registry.

    ``gen_kwargs`` flow into the generator spec (the reference's
    ``ns_kwargs``); ``override_sigma{,_next,_min,_max}`` replace the runtime
    sigmas (py/noise.py:100-134).
    """

    def __init__(
        self,
        factor: float = 1.0,
        *,
        noise_type: str,
        normalize: bool | None = None,
        override_sigma=None,
        override_sigma_next=None,
        override_sigma_min=None,
        override_sigma_max=None,
        **gen_kwargs,
    ):
        super().__init__(
            factor,
            normalize=normalize,
            noise_type=noise_type,
            override_sigma=override_sigma,
            override_sigma_next=override_sigma_next,
            override_sigma_min=override_sigma_min,
            override_sigma_max=override_sigma_max,
            gen_kwargs=dict(gen_kwargs),
        )
        from .presets import get_noise_item  # cycle: presets uses generators

        self._gen = get_noise_item(noise_type, factor=factor, normalize=normalize,
                                   **gen_kwargs)

    def clone(self):
        p = self.cloned_params()
        factor = p.pop("factor")
        gen_kwargs = p.pop("gen_kwargs")
        return self.__class__(factor, **p, **gen_kwargs)

    @property
    def SHARDABLE(self) -> bool:  # noqa: N802 (the other items' class attribute)
        """Whether the named noise draws a rank's block of a sharded latent."""
        from .base import shardable

        return shardable(self._gen)

    def _ctx(self, ctx: NoiseCtx) -> NoiseCtx:
        return dataclasses.replace(
            ctx,
            sigma_min=fallback(self.override_sigma_min, ctx.sigma_min),
            sigma_max=fallback(self.override_sigma_max, ctx.sigma_max),
        )

    def check_dims(self, ctx):
        self._gen.check_dims(ctx)

    def init_state(self, ctx, seed):
        return self._gen.init_state(self._ctx(ctx), seed)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        ctx = self._ctx(ctx)
        sigma = fallback(self.override_sigma, sigma)
        sigma_next = fallback(self.override_sigma_next, sigma_next)
        return self._gen.sample(ctx, state, seed, sigma, sigma_next, normalized=normalized)
