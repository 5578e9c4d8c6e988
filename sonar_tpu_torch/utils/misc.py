"""Misc utilities (port of ``sonar_tpu.utils.misc``; reference
py/utils.py). Ported so far: ``fallback``, ``maybe_apply``,
``clamp_float``, ``filter_dict``, the two step-from-sigma helpers that
wavelet CFG uses; and the port's own ``host_sigma``, default-device rule
and ``work_dtype``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def fallback(val, default=None):
    return val if val is not None else default


def maybe_apply(val, cond, fun):
    return fun(val) if cond else val


def clamp_float(val: float, minval: float = 0.0, maxval: float = 1.0) -> float:
    return max(minval, min(val, maxval))


def filter_dict(d: dict, keep, *, recursive: bool = False) -> dict:
    return {
        k: v if not (recursive and isinstance(v, dict)) else filter_dict(v, keep)
        for k, v in d.items()
        if k in keep
    }


def host_sigma(args: dict) -> float:
    """The step's sigma on the host, for a CFG-time function's ``args``:
    ``args["sigma_host"]`` where the caller carried it (the port's guided
    calls do), else the largest of ``args["sigma"]``, which reads a card
    tensor back."""
    s = args.get("sigma_host")
    if s is None:
        s = torch.as_tensor(args["sigma"]).max()
    return float(s)


def work_dtype(dtype):
    """The type FFTs and float32 transforms of a draw run in: float32 for
    bfloat16 and float16 (the FFT libraries take neither), else ``dtype``."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the one it was given, else the
    card. ``None`` never means the CPU: without a CUDA device the first
    allocation raises torch's own error. A caller that wants the CPU says
    ``device="cpu"``."""
    return torch.device("cuda" if device is None else device)


def step_from_sigmas(
    sigma: float,
    sigmas: Sequence[float] | np.ndarray,
    *,
    decimals: int | None = 4,
    output_decimals: int = 2,
) -> float | None:
    """Fractional step index of ``sigma`` in the step table, in float64, its
    result rounded to ``output_decimals`` (py/utils.py:682-721)."""
    sigma = float(np.max(np.asarray(sigma)))
    sigmas = np.asarray(sigmas, dtype=np.float64)
    if sigmas.ndim == 2:
        sigmas = sigmas.max(axis=0)
    elif sigmas.ndim != 1:
        raise ValueError(f"Unexpected sigmas shape {sigmas.shape}")
    sigmas = sigmas[:-1]
    if not len(sigmas) or np.any(sigmas <= 0):
        return None
    if decimals is not None:
        sigmas = np.round(sigmas, decimals)
        sigma = round(sigma, decimals)
    sigma_min, sigma_max = sigmas.min(), sigmas.max()
    if not sigma_min <= sigma <= sigma_max:
        return None
    max_idx = len(sigmas) - 1
    idx = int(np.argmin(np.abs(sigmas - sigma)))
    idx_sigma = float(sigmas[idx])
    if decimals is not None:
        idx_sigma = round(idx_sigma, decimals)
    if sigma == idx_sigma:
        return float(idx)
    idx_low, idx_high = (idx, idx - 1) if sigma > idx_sigma else (idx + 1, idx)
    if idx_low < 0 or idx_high < 0 or idx_low > max_idx or idx_high > max_idx:
        return None
    sigma_low, sigma_high = float(sigmas[idx_low]), float(sigmas[idx_high])
    step_diff = sigma_high - sigma_low
    if step_diff == 0:
        return float(idx)
    pct = 1.0 - ((sigma - sigma_low) / step_diff)
    return round(idx_high + pct, output_decimals)


def step_from_sigmas_f32(sigma, sigmas, *, decimals: int | None = 4) -> float | None:
    """The arithmetic of the JAX package's ``step_from_sigmas_traced`` on the
    host: float32 throughout, sigmas and sigma rounded as
    ``round(x * 10**decimals) / 10**decimals`` (half to even), and the
    fractional step NOT rounded to 2 decimals as :func:`step_from_sigmas`
    rounds it. Wavelet CFG's step percentages use this one. ``None`` where
    the traced variant reports ``valid == False``."""
    f32 = np.float32
    sigmas = np.asarray(sigmas, f32)[:-1]
    sigma = f32(sigma)
    if decimals is not None:
        fac = f32(10.0**decimals)
        sigmas = np.round(sigmas * fac) / fac
        sigma = f32(np.round(sigma * fac) / fac)
    if np.any(sigmas <= 0) or not sigmas.min() <= sigma <= sigmas.max():
        return None
    max_idx = len(sigmas) - 1
    idx = int(np.argmin(np.abs(sigmas - sigma)))
    if sigma == sigmas[idx]:
        return float(f32(idx))
    idx_low, idx_high = (idx, idx - 1) if sigma > sigmas[idx] else (idx + 1, idx)
    if not (0 <= idx_low <= max_idx and 0 <= idx_high <= max_idx):
        return None
    step_diff = sigmas[idx_high] - sigmas[idx_low]
    if step_diff == 0:
        return float(f32(idx))
    pct = f32(1.0) - (sigma - sigmas[idx_low]) / step_diff
    return float(f32(idx_high) + pct)
