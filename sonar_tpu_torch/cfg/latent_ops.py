"""Sigma-windowed latent operations (port of ``sonar_tpu.cfg.latent_ops``;
reference py/latent_ops.py).

Operations are callables ``op(latent=..., sigma=..., **extra) -> latent``.
The enable window is decided on the host when the step's sigma is known
there: the port's guided calls carry it as ``raw_args["sigma_host"]``, and
a number or a CPU tensor is read directly. Given only a tensor on the card,
the window is a ``torch.where`` select on the device, as the JAX package's
traced ``jnp.where`` (no read back). Randomness comes from the port's
Philox stream: ``SonarLatentOperationNoise`` derives each draw's seed from
(seed, the sigma's float32 bits), or takes ``seed=`` at call time where
the JAX package takes ``key=``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..core.normalize import quantile_normalize
from ..core.rng import derive_seed, seed_from
from ..noise.base import NoiseItem, make_noise_sampler


def _sigma_scalar(sigma, raw_args=None):
    """The step's sigma as a host float where the host has it, else the
    largest of a card tensor as a 0-dim card tensor; None for no sigma."""
    host = (raw_args or {}).get("sigma_host")
    if host is not None:
        return float(host)
    if sigma is None:
        return None
    if not isinstance(sigma, torch.Tensor):
        return float(np.max(np.asarray(sigma)))
    return float(sigma.max()) if sigma.device.type == "cpu" else sigma.max()


def _select(en, out, latent):
    """``out`` where the window is open: a host branch, or a device select."""
    if isinstance(en, (bool, np.bool_)):
        return out if en else latent
    return torch.where(en, out, latent)


class SonarLatentOperation:
    """Sigma-window gate around an op (py/latent_ops.py:15-58)."""

    EXTENDED_LATENT_OPERATION = True

    def __init__(self, *, start_sigma: float = math.inf, end_sigma: float = 0.0,
                 op: Callable | None = None):
        self.start_sigma = start_sigma if start_sigma >= 0 else math.inf
        self.end_sigma = end_sigma
        self.op = op

    def enabled(self, sigma=None, raw_args=None):
        s = _sigma_scalar(sigma, raw_args)
        if s is None:
            return True
        if isinstance(s, float):  # compared in float32, as the traced sigma is
            f32 = np.float32
            return bool(f32(self.end_sigma) <= f32(s) <= f32(self.start_sigma))
        return (s >= self.end_sigma) & (s <= self.start_sigma)

    def call_op(self, t, *, op=None, **kwargs):
        op = op if op is not None else self.op
        if op is None:
            return t
        if not getattr(op, "EXTENDED_LATENT_OPERATION", False):
            return op(latent=t)
        return op(latent=t, **kwargs)

    def __call__(self, latent, *, sigma=None, **kwargs):
        out = self.call_op(latent, sigma=sigma, **kwargs)
        return _select(self.enabled(sigma, kwargs.get("raw_args")), out, latent)


class SonarLatentOperationAdvanced(SonarLatentOperation):
    """Input/output/difference multipliers around a chained op list
    (py/latent_ops.py:61-106). The reference's inverted ``== 1.0``
    output_multiplier comparison (py/latent_ops.py:102) is kept for parity;
    ``strict_reference_compat=False`` gives the obvious fix."""

    def __init__(self, *, blend_mode: str = "inject", blend_strength: float = 1.0,
                 input_multiplier: float = 1.0, output_multiplier: float = 1.0,
                 difference_multiplier: float = 1.0, ops: Sequence = (),
                 op_alt=None, strict_reference_compat: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.blend_function = BLENDING_MODES[blend_mode]
        self.blend_strength = blend_strength
        self.input_multiplier = input_multiplier
        self.output_multiplier = output_multiplier
        self.difference_multiplier = difference_multiplier
        self.ops = tuple(ops)
        self.op_alt = op_alt
        self.strict_reference_compat = strict_reference_compat

    def __call__(self, latent, *, sigma=None, **kwargs):
        t = latent
        output = t * self.input_multiplier if self.input_multiplier != 1.0 else t
        for op in self.ops:
            output = self.call_op(output, sigma=sigma, op=op, **kwargs)
        apply_mult = (self.output_multiplier == 1.0 if self.strict_reference_compat
                      else self.output_multiplier != 1.0)
        diff = (output * self.output_multiplier if apply_mult else output) - t
        if self.difference_multiplier != 1.0:
            diff = diff * self.difference_multiplier
        result = self.blend_function(t, diff, self.blend_strength)
        alt = t if self.op_alt is None else self.call_op(t, sigma=sigma, op=self.op_alt,
                                                         **kwargs)
        return _select(self.enabled(sigma, kwargs.get("raw_args")), result, alt)


class SonarLatentOperationNoise(SonarLatentOperation):
    """Adds custom noise to the latent (py/latent_ops.py:109-187).

    Each draw's seed is derived from ``seed`` and the float32 bits of the
    step's sigma (the JAX package folds the same bits into its key):
    reproducible, and the same on the CPU and the card. ``seed=`` at call
    time sets the stream instead. The sigma must be known on the host
    (``raw_args["sigma_host"]``, a number or a CPU tensor); a card tensor
    is read back once."""

    def __init__(self, *, custom_noise: NoiseItem, scale_to_sigma: bool = False,
                 normalize: bool = True, seed: int = 0, sample_sigmas=None, **kwargs):
        super().__init__(**kwargs)
        self.custom_noise = custom_noise
        self.scale_to_sigma = scale_to_sigma
        self.normalize = normalize
        self.seed = seed
        self.sample_sigmas = sample_sigmas

    def __call__(self, latent, *, sigma=None, seed=None, **kwargs):
        t = latent
        s = _sigma_scalar(sigma, kwargs.get("raw_args"))
        if isinstance(s, torch.Tensor):
            s = float(s)
        sigma_next = s
        sigma_min = sigma_max = None
        if self.sample_sigmas is not None and s is not None:
            tbl = np.asarray(self.sample_sigmas)
            pos = tbl[tbl > 0]
            sigma_min = float(pos.min()) if pos.size else 0.0
            sigma_max = float(tbl.max())
            # sigma_next from the step table as the reference derives it
            # (py/latent_ops.py:148-155): only when sigma matches a table
            # entry exactly (in float32) and a next entry exists
            tbl32 = tbl.astype(np.float32)
            gstep = int(np.argmin(np.abs(tbl32 - np.float32(s))))
            if tbl32[gstep] == np.float32(s) and gstep + 1 < len(tbl32):
                sigma_next = float(tbl32[gstep + 1])
        if seed is None:
            seed = seed_from(self.seed)
            if s is not None:
                bits = int(np.float32(s).view(np.int32)) & 0x7FFFFFFF
                seed = derive_seed(seed, bits)
        fn, state = make_noise_sampler(
            self.custom_noise, tuple(t.shape), dtype=t.dtype, device=t.device, seed=seed,
            sigma_min=sigma_min, sigma_max=sigma_max, normalized=self.normalize,
            ref_latent=t)
        noise, _state = fn(state, s, sigma_next)
        if self.scale_to_sigma and s is not None:
            noise = noise * s
        return _select(self.enabled(sigma, kwargs.get("raw_args")), t + noise, t)


class SonarLatentOperationQuantileFilter(SonarLatentOperation):
    """quantile_normalize as a latent operation
    (py/nodes/latent_operations.py:317-352)."""

    def __init__(self, *, quantile=0.85, dim=1, flatten=True, nq_fac=1.0,
                 pow_fac=0.5, strategy="clamp", **kwargs):
        super().__init__(**kwargs)
        self.qn_kwargs = dict(quantile=quantile, dim=dim, flatten=flatten,
                              nq_fac=nq_fac, pow_fac=pow_fac, strategy=strategy)

    def __call__(self, latent, *, sigma=None, **kwargs):
        out = quantile_normalize(latent, **self.qn_kwargs)
        return _select(self.enabled(sigma, kwargs.get("raw_args")), out, latent)


def apply_operations(latent, operations: Sequence, *, sigma=None, **kwargs):
    for op in operations:
        latent = op(latent=latent, sigma=sigma, **kwargs) if getattr(
            op, "EXTENDED_LATENT_OPERATION", False) else op(latent=latent)
    return latent
