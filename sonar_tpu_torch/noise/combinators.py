"""Noise combinators (port of ``sonar_tpu.noise.combinators``; reference
py/noise.py:470-2241). Ported so far: :class:`WrapperNoise`, the base of
the single-child wrappers, :class:`ScheduledNoise` and
:class:`CustomNoiseParametersNoise`; the rest of the algebra follows in
later slices.

A combinator is a :class:`~.base.NoiseItem` whose ``sample`` composes child
items. The children's persistent state lives in this node's state dict, and
child ``i`` is initialised on ``derive_seed(seed, i)``, as the JAX package
folds ``i`` into its key. The sampler's sigmas are host numbers, so a
sigma-conditional choice (the JAX package's ``lax.cond``) is a host branch:
as there, only the chosen branch runs, and the other child's state does not
advance.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.normalize import scale_noise
from ..core.rng import derive_seed, seed_from
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


class CustomNoiseParametersNoise(WrapperNoise):
    """Parameter-override wrapper (py/noise.py:2080-2187).

    - ``frames_to_channels`` folds a 5D (B, C, F, H, W) context into a 4D
      (B, C·F, H, W) one for the child and the draw back;
    - ``ensure_square_aspect_ratio`` draws on the smallest square that
      holds the pixels and crops;
    - ``fix_invalid`` maps NaN to 0 and ±inf to the finite max/min;
    - ``override_dtype`` draws in another type; ``override_device`` is
      accepted and changes nothing (every stream is the same on the CPU and
      the card), nor does ``rng_mode`` (the streams are explicit seeds);
    - ``rng_offset_mode`` ``"add"`` derives the seeds with
      ``rng_state_offset``; ``"override"`` draws from a stream of
      ``rng_state_offset`` alone, a draw counter in the state advancing it,
      as the JAX package carries one.
    """

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, override_dtype=None,
                 override_device=None, frames_to_channels=False,
                 ensure_square_aspect_ratio=False, fix_invalid=False,
                 rng_mode="default", rng_offset_mode="disabled",
                 rng_state_offset=0, normalize=None):
        super().__init__(factor, normalize=normalize, noise=noise,
                         override_dtype=override_dtype,
                         override_device=override_device,
                         frames_to_channels=frames_to_channels,
                         ensure_square_aspect_ratio=ensure_square_aspect_ratio,
                         fix_invalid=fix_invalid, rng_mode=rng_mode,
                         rng_offset_mode=rng_offset_mode,
                         rng_state_offset=rng_state_offset)

    def _folded(self, ctx) -> tuple[tuple[int, ...], int]:
        """The child's shape before the square adjustment, and its number of
        spatial axes."""
        shape = tuple(ctx.shape)
        if len(shape) == 5 and self.frames_to_channels:
            shape = (shape[0], shape[1] * shape[2]) + shape[3:]
        return shape, 1 if len(shape) == 3 else 2

    def child_ctx(self, ctx):
        shape, spatdims = self._folded(ctx)
        ref = ctx.ref
        if ref is not None and shape != tuple(ctx.shape) and tuple(ref.shape) == tuple(ctx.shape):
            ref = ref.reshape(shape)
        if self.ensure_square_aspect_ratio:
            height = 1 if len(shape) == 3 else shape[-2]
            hw = (height * shape[-1]) ** 0.5
            if not float(hw).is_integer():
                hw = math.ceil(hw)
                shape = shape[:-spatdims] + (hw, hw)
        return dataclasses.replace(ctx, shape=shape, dtype=self.override_dtype or ctx.dtype,
                                   ref=ref)

    def init_state(self, ctx, seed):
        if self.rng_offset_mode == "override":
            seed = seed_from(self.rng_state_offset)
        elif self.rng_offset_mode == "add":
            seed = derive_seed(seed, self.rng_state_offset)
        st = super().init_state(ctx, seed)
        if self.rng_offset_mode == "override":
            st = {**st, "_rng_i": 0}
        return st

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        if self.rng_offset_mode == "override":
            seed = derive_seed(seed_from(self.rng_state_offset), state["_rng_i"])
            state = {**state, "_rng_i": state["_rng_i"] + 1}
        elif self.rng_offset_mode == "add":
            seed = derive_seed(seed, self.rng_state_offset)
        cctx = self.child_ctx(ctx)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=False)
        if self.fix_invalid:
            finite = torch.nan_to_num(noise, nan=0.0, posinf=0.0, neginf=0.0)
            noise = torch.nan_to_num(noise, nan=0.0, posinf=math.inf, neginf=-math.inf)
            noise = torch.where(torch.isposinf(noise), finite.max(), noise)
            noise = torch.where(torch.isneginf(noise), finite.min(), noise)
        if self.ensure_square_aspect_ratio and cctx.shape != tuple(ctx.shape):
            hw_shape, spat = self._folded(ctx)
            hw = hw_shape[-spat:]
            flat = noise.reshape(noise.shape[:-spat] + (-1,))[..., : math.prod(hw)]
            noise = flat.reshape(flat.shape[:-1] + tuple(hw))
        if noise.shape != tuple(ctx.shape):
            noise = noise.reshape(tuple(ctx.shape))
        return scale_noise(noise.to(ctx.dtype), self.factor, normalized=normalize), state
