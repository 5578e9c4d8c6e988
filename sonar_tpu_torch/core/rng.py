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

Student-t (``studentt_polar``, ``draw_t``) is not ported yet.
"""

from __future__ import annotations

import zlib

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
