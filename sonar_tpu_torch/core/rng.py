"""Counter-based seed derivation (port of ``sonar_tpu.core.rng``).

JAX derives independent streams by folding a path into a threefry key. The
port does the same with plain integers: :func:`derive_seed` folds a path of
ints and strings (strings by crc32, as in JAX) into a 64-bit seed, and each
draw's seed comes from (seed, path, draw counter). There is no global RNG
state, and the counter lives in the caller's state, so a run that stops and
resumes draws exactly what an uninterrupted run draws.

Every gaussian and uniform draw turns its seed into noise through one
counter-based stream, Philox4x32-10 with Box-Muller
(:mod:`sonar_tpu_torch.kernels.hwrng`): a CUDA kernel on the card and the
same integer arithmetic in plain PyTorch on the CPU. So, as in the JAX
package, noise streams are identical across devices: the same seed gives
the same noise on the CPU and on the card (the uniforms bit for bit, the
normals to a few ulps of log/cos/sin). The port's streams are its own:
Philox does not reproduce threefry's bits.

Student-t (:func:`studentt_polar`, :func:`draw_t`) and Laplace
(:func:`draw_laplace`) draws are transforms of Philox uniforms, computed in
float32 when the type is narrower and rounded once.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from ..kernels.hwrng import philox_rand
from ..utils.misc import work_dtype

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijective avalanche on 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seed_from(seed: int | None) -> int:
    """Normalize a user seed (None → 0) to a 64-bit stream seed."""
    return _mix64((0 if seed is None else int(seed)) & _MASK64)


def derive_seed(seed: int, *path: int | str) -> int:
    """Derive a sub-seed deterministically from a path of ints/strings.

    Strings are hashed with crc32, so stream identity depends only on the
    spelled path (``"noise"``, ``"init"``, ``"rand_init"``, a counter)."""
    s = int(seed) & _MASK64
    for p in path:
        if isinstance(p, str):
            p = zlib.crc32(p.encode("utf-8"))
        s = _mix64(s ^ _mix64(int(p) & 0x7FFFFFFF))
    return s


def studentt_polar(seed: int, df, shape, dtype=torch.float32, *, device,
                   shard=None) -> torch.Tensor:
    """Exact Student-t draws by the spherical polar construction, with no
    rejection: for a 2D spherically symmetric Student-t with ``df`` degrees
    of freedom the radius has the closed-form tail ``P(R > r) = (1 +
    r²/df)^{-df/2}`` (inverse: ``R = sqrt(df·(U^{-2/df} - 1))``), and every
    1D marginal of the multivariate t is t_df, so ``R·cos(2πV)`` with ``U,
    V ~ Uniform`` is exactly t_df (Bailey's 1994 polar method without its
    rejection step). ``U`` and ``V`` are the Philox uniforms of
    ``derive_seed(seed, 0)`` and ``(seed, 1)``, as the JAX package splits
    its key in two. ``shard`` draws a slice of the draw (kernel B3's)."""
    cdt = work_dtype(dtype)
    kw = {} if shard is None else {"shard": shard}
    u = 1.0 - philox_rand(derive_seed(seed, 0), shape, device=device, dtype=cdt, **kw)  # (0, 1]
    v = philox_rand(derive_seed(seed, 1), shape, device=device, dtype=cdt, **kw)
    # the scalars as the JAX package computes them, in float32 (host numbers:
    # a device tensor made from them would be a copy to the card per draw)
    df32 = np.float32(df)
    r = torch.sqrt(float(df32) * torch.expm1(float(np.float32(-2.0) / df32) * torch.log(u)))
    return (r * torch.cos(float(np.float32(2.0 * math.pi)) * v)).to(dtype)


def draw_t(seed: int, df, shape, dtype=torch.float32, *, device, shard=None) -> torch.Tensor:
    """Student-t draw: the polar construction (the JAX package's default;
    its gamma-rejection alternative is not ported)."""
    return studentt_polar(seed, df, shape, dtype, device=device,
                          **({} if shard is None else {"shard": shard}))


def draw_laplace(seed: int, shape, dtype=torch.float32, *, device,
                 shard=None) -> torch.Tensor:
    """Standard Laplace draws by ``jax.random.laplace``'s inverse-CDF
    transform of one uniform: ``u`` in ``[-1 + 2⁻²⁴, 1)``, then
    ``sign(u)·log1p(-|u|)``."""
    lo = -1.0 + 2.0**-24  # exact in float32; 1 - lo rounds to 2 there, as in JAX
    u = philox_rand(seed, shape, device=device, dtype=work_dtype(dtype),
                    **({} if shard is None else {"shard": shard}))
    u = torch.clamp(u * 2.0 + lo, min=lo)
    return (torch.sign(u) * torch.log1p(-torch.abs(u))).to(dtype)
