"""A frozen copy of the noise stream the program is held to: seed
derivation, Philox4x32-10 and Box-Muller, in plain PyTorch integer and
float32 arithmetic.

This is the stream's definition as the port states it (its ``kernels/hwrng.py``
docstring and ``core/rng.py``), written out again here so that a later change
to the program cannot move the yardstick with it:

- a user seed becomes a 64-bit stream seed by splitmix64's finalizer
  (:func:`seed_from`); a sub-seed folds a path of integers and strings
  (strings by crc32) into it (:func:`derive_seed`);
- a draw's key is its 64-bit seed split into (low, high) 32-bit words;
- element ``4g + k`` of the row-major output comes from one Philox4x32-10
  call on the counter ``(g low, g high, stream, 0)``;
- normals: Box-Muller on 24-bit uniforms, ``u1 = ((a >> 8) + 1)·2⁻²⁴``,
  the angle ``2π·(b >> 8)·2⁻²⁴`` reduced exactly on the integer to a
  quarter turn and a float32 remainder in ``[-π/4, π/4)``; words
  ``(x0, x1)`` give elements ``4g`` (cosine) and ``4g+1`` (sine), words
  ``(x2, x3)`` elements ``4g+2`` and ``4g+3``.
"""

from __future__ import annotations

import math
import zlib

import torch

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seed_from(seed: int | None) -> int:
    """A user seed (None is 0) as a 64-bit stream seed."""
    return _mix64((0 if seed is None else int(seed)) & _MASK64)


def derive_seed(seed: int, *path: int | str) -> int:
    """The sub-seed of ``seed`` at ``path`` (integers, or strings by crc32)."""
    s = int(seed) & _MASK64
    for p in path:
        if isinstance(p, str):
            p = zlib.crc32(p.encode("utf-8"))
        s = _mix64(s ^ _mix64(int(p) & 0x7FFFFFFF))
    return s


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 tensors holding uint32 words (a 32×32
    bit product wraps modulo 2⁶⁴ in int64, and its high word survives)."""
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _box_muller(a, b):
    u1 = ((a >> 8) + 1).to(torch.float32) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u1))
    k = (b >> 8) + (1 << 21)
    quarter = k >> 22
    j = (k & ((1 << 22) - 1)) - (1 << 21)
    phi = j.to(torch.float32) * torch.tensor(math.pi, dtype=torch.float32) * 2.0**-23
    c, s = torch.cos(phi), torch.sin(phi)
    swap = (quarter & 1) != 0
    cos_t, sin_t = torch.where(swap, s, c), torch.where(swap, c, s)
    cos_t = torch.where(((quarter + 1) & 2) != 0, -cos_t, cos_t)
    sin_t = torch.where((quarter & 2) != 0, -sin_t, sin_t)
    return r * cos_t, r * sin_t


def randn(seed: int, shape, *, device, stream: int = 0) -> torch.Tensor:
    """Float32 N(0, 1) draws of ``shape`` from the stream of ``seed``."""
    shape = tuple(shape)
    n = math.prod(shape)
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    s = int(seed) & _MASK64
    x0, x1, x2, x3 = _philox(g & _MASK32, g >> 32, torch.full_like(g, int(stream) & _MASK32),
                             torch.zeros_like(g), s & _MASK32, s >> 32)
    cols = [*_box_muller(x0, x1), *_box_muller(x2, x3)]
    return torch.stack(cols, dim=1).reshape(-1)[:n].reshape(shape)
