"""Noise normalization primitives (port of ``sonar_tpu.core.normalize``).

- ``tstd`` — Bessel-corrected std (ddof=1), the reference's statistic.
- ``scale_noise`` — the canonical mean-0/std-1 normalizer with a
  2.5/sqrt(N) significance dead-band (py/utils.py:85-106).

The data-dependent branches are ``torch.where`` selects on device values:
a Python ``if`` on a tensor would wait for the card once per noise draw.
The global mode is kernel B2's wrapper, so on a CUDA tensor it launches the
kernel and on a CPU tensor it runs the plain version.

The quantile strategies (``quantile_normalize`` and friends) are not ported
yet.
"""

from __future__ import annotations

import torch

from ..kernels.fused import fused_scale_noise


def _static_one(factor) -> bool:
    return isinstance(factor, (int, float)) and factor == 1


def tstd(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Bessel-corrected std matching ``torch.Tensor.std`` (ddof=1)."""
    return torch.std(x, dim=dim, correction=1, keepdim=keepdim)


def scale_noise(
    noise: torch.Tensor,
    factor=1.0,
    *,
    normalized: bool = True,
    threshold_std_devs: float = 2.5,
    normalize_dims: tuple | None = None,
) -> torch.Tensor:
    """THE normalizer (py/utils.py:85-106).

    Global mode: the mean is subtracted only if ``|mean| > 2.5/sqrt(N)``
    and the array is divided by the *original* std only if
    ``|1-std| > 2.5/sqrt(N)``, so noise that is already standard normal
    passes through untouched bit for bit.

    Per-dims mode: divide by the per-dims std, then subtract the
    post-division per-dims mean (that exact order, py/utils.py:96-99).

    Zero-std guard in both modes: constant noise passes through instead of
    the reference's 0/0 NaN.
    """
    if not normalized or noise.numel() == 0:
        return noise if _static_one(factor) else noise * factor
    if normalize_dims is not None:
        dims = tuple(normalize_dims)
        std = tstd(noise, dim=dims, keepdim=True)
        noise = noise / torch.where(std == 0, torch.ones_like(std), std)
        noise = noise - noise.mean(dim=dims, keepdim=True)
        return noise if _static_one(factor) else noise * factor
    return fused_scale_noise(noise, factor, threshold_std_devs=threshold_std_devs)
