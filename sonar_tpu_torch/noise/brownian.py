"""Brownian-bridge noise via a truncated Lévy–Ciesielski construction (port
of ``sonar_tpu.noise.brownian``; the reference delegates to torchsde's
BrownianTree, py/noise_generation.py:263-286):
``ns(sigma, sigma_next) = (W(t1) - W(t0)) / sqrt(|t1 - t0|)`` on the interval
[sigma_min, sigma_max].

W(u) is a pure function of a fixed seed, the Schauder expansion cut at
``levels`` dyadic levels::

    W(u) = u·Z_0 + Σ_{l<L} 2^{-(l+2)/2} · tri(2^l·u - k) · Z_{l,k},
    k = floor(2^l·u),  tri(f) = 1 - |2f - 1|

per element, each Z an iid standard-normal tensor. Because W is a function
of u alone, interval consistency (W(a,c) = W(a,b) + W(b,c)) holds exactly,
and increments have Brownian statistics at the dyadic resolution 2^-levels.

The sampler's sigmas are host numbers, so ``u`` is a host float here and
``k`` a host integer: the normal of (level ``l``, cell ``k``) is one draw of
the port's Philox stream (kernel B3 on the card) on
``derive_seed(base, l + 1, k)``, and Z_0 one on ``derive_seed(base, 0)``, as
the JAX package folds ``l + 1`` and ``k`` into its key. One evaluation is
``levels + 1`` draws and as many small accumulate kernels. The scalar
arithmetic (u, the cell, the tent, the scale) runs in float32 on the host,
as the JAX package's traced scalars do.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.rng import derive_seed
from ..kernels.hwrng import philox_randn
from ..utils.misc import default_device

_F32 = np.float32


def _rounded(v, dtype) -> float:
    """``v`` (a float32 host scalar) as a Python float after the rounding to
    ``dtype`` that the JAX package's ``.astype(dtype)`` gives it."""
    if dtype == torch.float32:
        return float(v)
    return float(torch.tensor(float(v), dtype=torch.float32).to(dtype))


def unit_time(t, t_lo, t_hi) -> np.float32:
    """``(t - t_lo) / (t_hi - t_lo)`` in float32."""
    return (_F32(t) - _F32(t_lo)) / (_F32(t_hi) - _F32(t_lo))


def brownian_normals(seed: int, shape, *, device, dtype=torch.float32,
                     shard=None) -> Callable:
    """The default source of W's normals: ``normals(j, k)`` is the tensor of
    fold ``j`` (0 for Z_0, ``l + 1`` for level ``l``) and cell ``k``
    (``shard``: the slice of each draw that a rank's block holds, kernel
    B3's)."""

    def normals(j: int, k: int) -> torch.Tensor:
        s = derive_seed(seed, 0) if j == 0 else derive_seed(seed, j, k)
        return philox_randn(s, shape, device=device, dtype=dtype,
                            **({} if shard is None else {"shard": shard}))

    return normals


def brownian_w(seed: int, u, shape, *, levels: int = 16, dtype=torch.float32,
               device=None, normals: Callable | None = None, shard=None) -> torch.Tensor:
    """Evaluate W(u) elementwise for a host ``u`` in [0, 1] (clipped).

    ``normals(j, k)`` replaces the Philox draws (a test feeds two
    implementations the same numpy tensors); it must return a tensor of
    ``shape`` that this function may read but does not change."""
    shape = tuple(shape)
    if normals is None:
        normals = brownian_normals(seed, shape, device=default_device(device), dtype=dtype,
                                   **({} if shard is None else {"shard": shard}))
    u = min(max(_F32(u), _F32(0.0)), _F32(1.0))
    acc = normals(0, 0) * _rounded(u, dtype)
    for lvl in range(levels):
        scale = _F32(2.0 ** (-(lvl + 2) / 2.0))
        pos = u * _F32(2.0**lvl)
        # clamp the u == 1 edge into the last cell so tri() sees f in [0, 1]
        k = min(int(np.floor(pos)), 2**lvl - 1)
        f = pos - _F32(k)
        tri = _F32(1.0) - abs(_F32(2.0) * f - _F32(1.0))
        acc.add_(normals(lvl + 1, k), alpha=_rounded(scale * tri, dtype))
    return acc


def brownian_increment(seed: int, t0, t1, shape, *, t_lo, t_hi, levels: int = 16,
                       dtype=torch.float32, device=None, w0: torch.Tensor | None = None,
                       normals: Callable | None = None, shard=None):
    """``((W(t1) - W(t0)) / sqrt(|t1 - t0|), W(t1))`` on [t_lo, t_hi].

    Pass a precomputed ``w0 = W(u0)`` to skip one full evaluation (the
    stateful generator carries the previous endpoint across steps)."""
    kw = dict(levels=levels, dtype=dtype, device=device, normals=normals, shard=shard)
    if w0 is None:
        w0 = brownian_w(seed, unit_time(t0, t_lo, t_hi), shape, **kw)
    w1 = brownian_w(seed, unit_time(t1, t_lo, t_hi), shape, **kw)
    # sqrt(span) converts unit-interval W to the [t_lo, t_hi] scale
    denom = np.sqrt(abs(_F32(t1) - _F32(t0)))
    if denom == 0:
        denom = _F32(1.0)
    factor = np.sqrt(_F32(t_hi) - _F32(t_lo)) / denom
    return (w1 - w0) * _rounded(factor, dtype), w1


def brownian_w_at(seed: int, t, shape, *, t_lo, t_hi, levels: int = 16,
                  dtype=torch.float32, device=None, normals: Callable | None = None):
    """W at a sigma point (for seeding the endpoint cache)."""
    return brownian_w(seed, unit_time(t, t_lo, t_hi), shape, levels=levels, dtype=dtype,
                      device=device, normals=normals)


# ---------------------------------------------------------------------------
# The endpoint cache of the sigma-correlated noises (``brownian``,
# time-brownian power noise): consecutive sampler steps share
# W(sigma_next_i) == W(sigma_{i+1}), so carrying it saves one of a step's two
# evaluations of W. The state is ``{"base", "u_last", "w_last"}``; ``u_last``
# is a host float (the sigmas are host numbers), so the JAX package's
# ``lax.cond`` on ``|u0 - u_last| < 1e-6`` is a host branch.
# ---------------------------------------------------------------------------


def endpoint_state(ctx, seed: int, dtype=None) -> dict:
    """The initial state for a noise context with ``sigma_min``/``sigma_max``."""
    if ctx.sigma_min is None or ctx.sigma_max is None:
        raise ValueError("Brownian noise requires sigma_min and sigma_max")
    return {"base": seed, "u_last": -1e9,
            "w_last": torch.zeros(tuple(ctx.shape), dtype=dtype or ctx.dtype,
                                  device=default_device(ctx.device))}


def endpoint_increment(ctx, state, sigma, sigma_next, *, levels: int = 16, dtype=None):
    """``(noise, new_state)`` for the step sigma -> sigma_next on the path of
    ``state["base"]``; ``state`` is left as it was."""
    kw = dict(levels=levels, dtype=dtype or ctx.dtype, device=default_device(ctx.device),
              shard=ctx.field_shard(ctx.shape))
    u0 = unit_time(sigma, ctx.sigma_min, ctx.sigma_max)
    if abs(u0 - _F32(state["u_last"])) < 1e-6:
        w0 = state["w_last"]
    else:
        w0 = brownian_w(state["base"], u0, tuple(ctx.shape), **kw)
    noise, w1 = brownian_increment(
        state["base"], sigma, sigma_next, tuple(ctx.shape), t_lo=ctx.sigma_min,
        t_hi=ctx.sigma_max, w0=w0, **kw)
    u1 = unit_time(sigma_next, ctx.sigma_min, ctx.sigma_max)
    return noise, {**state, "u_last": float(min(max(u1, 0.0), 1.0)), "w_last": w1}
