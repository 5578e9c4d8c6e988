"""The port's one noise stream: Philox4x32-10 with Box-Muller (kernel B3).

Counterpart of ``sonar_tpu.kernels.hwrng``. The TPU kernel drew its bits
from the TPU's hardware generator, reseeded per grid block; Hopper has no
such generator, so the port uses a counter-based one whose stream is a pure
function of (seed, element index). The CUDA kernel (``csrc/hwrng.cu`` with
the device functions of ``csrc/philox.cuh``) and the plain PyTorch version
below compute the same integer arithmetic, so a seed gives the same noise on
the CPU and on the card.

Stream definition (both versions follow it):

- key = the 64-bit draw seed (from :func:`~sonar_tpu_torch.core.rng.derive_seed`)
  split into two 32-bit words, ``(seed & 0xFFFFFFFF, seed >> 32)``;
- the flat output is cut into groups of four elements; group ``g`` (elements
  ``4g .. 4g+3`` of the row-major flattening) is one Philox4x32-10 call on
  the counter ``(g & 0xFFFFFFFF, g >> 32, stream, 0)``, giving four 32-bit
  words ``x0..x3``. The counter depends on the element index alone, never on
  a grid, block or tile, so the plain version reproduces every word;
- uniforms (:func:`philox_rand`): element ``4g+k`` is
  ``(x_k >> 8) · 2⁻²⁴ ∈ [0, 1)``;
- normals (:func:`philox_randn`): Box-Muller on the 24-bit uniforms of
  ``sonar_tpu/kernels/hwrng.py:57-67``, ``u1 = ((a >> 8) + 1) · 2⁻²⁴ ∈ (0, 1]``
  and ``u2 = k · 2⁻²⁴ ∈ [0, 1)`` with ``k = b >> 8``: ``r = sqrt(-2 log u1)``
  and the angle ``θ = 2π·k·2⁻²⁴``, taken exactly. The angle is reduced on
  the integer, with no rounding: ``q = (k + 2²¹) >> 22`` is the nearest
  quarter turn, ``j = k − q·2²² ∈ [−2²¹, 2²¹)``, ``φ = j · (π·2⁻²³)`` (π
  rounded to float32) ``∈ [−π/4, π/4)``, and ``(cos θ, sin θ)`` is
  ``(cos φ, sin φ)`` turned by ``q`` quarter turns (a swap and two signs).
  Element ``4g`` gets ``r·cos θ`` and ``4g+1`` gets ``r·sin θ`` of the pair
  ``(x0, x1)``; ``4g+2`` and ``4g+3`` get the cosine and sine of the pair
  ``(x2, x3)``.

The uniforms agree bit for bit between the versions. The normals agree to
2e-6 absolute (measured: see ``chip_smoke.py`` phase 6, which also runs all
2²⁴ arguments of the kernel's radius and of its sine and cosine against
float64): the kernel evaluates ``φ``'s sine and cosine and the logarithm by
polynomials written for these arguments and takes the root by ``rsqrt`` with
a Newton step, the plain version calls torch's functions on the same ``φ``
and ``u1``.

Before the fold was part of the definition the angle was the float32
product ``2π·u2``, which is off the exact angle by up to 4.2e-7 rad: a
seed's normals differ from those drawn under that definition in their last
bits, by at most 4.2e-7·r + 5e-7 ≤ 3e-6 absolute (r ≤ 5.77). Uniforms and
Philox words are unchanged, and a seed still gives one noise on the CPU and
on the card.

A draw in bfloat16 or float16 is the float32 value rounded once to nearest
even, by the kernel at its store and by the plain version's ``.to(dtype)``.

``stream`` separates fields drawn under one seed (kernels B4 and B5 use it
for the base pair and for each (level, plane) field).

Each wrapper runs its kernel on a CUDA device and counts the launch in
``launches``; on the CPU it runs the plain version and counts nothing; any
other device raises.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def philox_key(seed: int) -> tuple[int, int]:
    """The Philox key of a 64-bit seed: (low word, high word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _MASK32, s >> 32


def philox4x32_reference(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors that hold uint32 words.

    Torch has no unsigned 64-bit multiply; a 32×32-bit product in int64
    wraps modulo 2⁶⁴, and ``(p >> 32) & 0xFFFFFFFF`` is still its high
    word."""
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_words(seed: int, n: int, *, device, stream: int = 0):
    """The four Philox words of each of the ``⌈n/4⌉`` groups."""
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    k0, k1 = philox_key(seed)
    return philox4x32_reference(g & _MASK32, g >> 32,
                                torch.full_like(g, int(stream) & _MASK32),
                                torch.zeros_like(g), k0, k1)


def box_muller_pair(a, b):
    """(r·cos θ, r·sin θ) from two words of Philox bits, θ = 2π·(b >> 8)·2⁻²⁴
    reduced exactly on the integer (the module docstring has the fold)."""
    u1 = ((a >> 8) + 1).to(torch.float32) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u1))
    kr = (b >> 8) + (1 << 21)
    q = kr >> 22
    j = (kr & ((1 << 22) - 1)) - (1 << 21)
    phi = j.to(torch.float32) * torch.tensor(math.pi, dtype=torch.float32) * 2.0**-23
    c, s = torch.cos(phi), torch.sin(phi)
    swap = (q & 1) != 0
    cos_t, sin_t = torch.where(swap, s, c), torch.where(swap, c, s)
    cos_t = torch.where(((q + 1) & 2) != 0, -cos_t, cos_t)
    sin_t = torch.where((q & 2) != 0, -sin_t, sin_t)
    return r * cos_t, r * sin_t


def _interleave(cols, n: int, shape, dtype):
    return torch.stack(cols, dim=1).reshape(-1)[:n].reshape(shape).to(dtype)


def philox_randn_reference(seed: int, shape, *, device, dtype=torch.float32,
                           stream: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel B3's normals."""
    shape = tuple(shape)
    n = math.prod(shape)
    x0, x1, x2, x3 = philox_words(seed, n, device=device, stream=stream)
    return _interleave([*box_muller_pair(x0, x1), *box_muller_pair(x2, x3)],
                       n, shape, dtype)


def philox_rand_reference(seed: int, shape, *, device, dtype=torch.float32,
                          stream: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel B3's uniforms in [0, 1)."""
    shape = tuple(shape)
    n = math.prod(shape)
    words = philox_words(seed, n, device=device, stream=stream)
    return _interleave([(x >> 8).to(torch.float32) * 2.0**-24 for x in words],
                       n, shape, dtype)


def _launch(wrapper, seed, shape, device, dtype, stream, normal: bool):
    from ._build import check, load_library

    # the kernel stores float32, bfloat16 and float16; any other type is
    # converted from its float32 draw
    stored = dtype if dtype in _DTYPE_CODES else torch.float32
    out = torch.empty(tuple(shape), dtype=stored, device=device)
    if out.numel():
        lib = load_library()
        k0, k1 = philox_key(seed)
        with torch.cuda.device(out.device):
            cuda_stream = torch.cuda.current_stream().cuda_stream
            err = lib.sonar_philox_fill(out.data_ptr(), out.numel(), k0, k1,
                                        int(stream) & _MASK32, int(normal),
                                        _DTYPE_CODES[stored], cuda_stream)
        check(lib, err, wrapper.__name__)
        wrapper.launches += 1
    return out if stored == dtype else out.to(dtype)


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"philox: no kernel and no plain version for device {d}")
    return d


def philox_randn(seed: int, shape, *, device, dtype=torch.float32,
                 stream: int = 0) -> torch.Tensor:
    """N(0, 1) noise of ``shape`` from the stream of ``seed``."""
    device = _device(device)
    if device.type == "cpu":
        return philox_randn_reference(seed, shape, device=device, dtype=dtype,
                                      stream=stream)
    return _launch(philox_randn, seed, shape, device, dtype, stream, normal=True)


def philox_rand(seed: int, shape, *, device, dtype=torch.float32,
                stream: int = 0) -> torch.Tensor:
    """U[0, 1) noise of ``shape`` from the stream of ``seed``."""
    device = _device(device)
    if device.type == "cpu":
        return philox_rand_reference(seed, shape, device=device, dtype=dtype,
                                     stream=stream)
    return _launch(philox_rand, seed, shape, device, dtype, stream, normal=False)


philox_randn.launches = 0
philox_rand.launches = 0
