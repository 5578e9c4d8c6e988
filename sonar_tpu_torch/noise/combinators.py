"""Noise combinators (port of ``sonar_tpu.noise.combinators``; reference
py/noise.py:470-2241). Ported so far: :class:`WrapperNoise`, the base of
the single-child wrappers, and :class:`ScheduledNoise`; the rest of the
algebra follows in later slices.

A combinator is a :class:`~.base.NoiseItem` whose ``sample`` composes child
items. The children's persistent state lives in this node's state dict, and
child ``i`` is initialised on ``derive_seed(seed, i)``, as the JAX package
folds ``i`` into its key. The sampler's sigmas are host numbers, so a
sigma-conditional choice (the JAX package's ``lax.cond``) is a host branch:
as there, only the chosen branch runs, and the other child's state does not
advance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.normalize import scale_noise
from ..core.rng import derive_seed
from ..utils.misc import default_device
from .base import NoiseCtx, NoiseItem


class WrapperNoise(NoiseItem):
    """Base for single-child wrappers: handles child state plumbing."""

    CHILD_KEYS: tuple[str, ...] = ("noise",)

    def _children(self) -> dict[str, NoiseItem | None]:
        return {k: getattr(self, k, None) for k in self.CHILD_KEYS}

    def check_dims(self, ctx):
        super().check_dims(ctx)
        for child in self._children().values():
            if child is not None:
                child.check_dims(self.child_ctx(ctx))

    def child_ctx(self, ctx: NoiseCtx) -> NoiseCtx:
        return ctx

    def init_state(self, ctx, seed):
        cctx = self.child_ctx(ctx)
        return {
            k: (None if c is None else c.init_state(cctx, derive_seed(seed, i)))
            for i, (k, c) in enumerate(self._children().items())
        }

    def child_sample(self, name, ctx, state, seed, sigma, sigma_next, *, normalized):
        child = getattr(self, name)
        noise, cstate = child.sample(
            self.child_ctx(ctx), state[name], seed, sigma, sigma_next,
            normalized=normalized,
        )
        return noise, {**state, name: cstate}


class ScheduledNoise(WrapperNoise):
    """Sigma-window main/fallback select (py/noise.py:626-678): ``noise``
    while ``end_sigma <= sigma <= start_sigma`` (compared in float32, as the
    JAX package compares its float32 sigma), else ``fallback_noise`` (zeros
    without one)."""

    CHILD_KEYS = ("noise", "fallback_noise")

    def __init__(self, factor=1.0, *, noise, start_sigma=math.inf, end_sigma=0.0,
                 fallback_noise=None, normalize=None):
        super().__init__(
            factor, normalize=normalize,
            noise=noise, fallback_noise=fallback_noise,
            start_sigma=start_sigma, end_sigma=end_sigma,
        )

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        if sigma is None or sigma_next is None:
            raise ValueError("ScheduledNoise requires sigma, sigma_next to be passed")
        normalize = self.get_normalize("normalize", normalized)
        s = np.float32(sigma)
        if np.float32(self.end_sigma) <= s <= np.float32(self.start_sigma):
            noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                             normalized=False)
        elif self.fallback_noise is None:
            noise = torch.zeros(tuple(ctx.shape), dtype=ctx.dtype,
                                device=default_device(ctx.device))
        else:
            noise, state = self.child_sample("fallback_noise", ctx, state, seed, sigma,
                                             sigma_next, normalized=False)
        return scale_noise(noise, self.factor, normalized=normalize), state
