"""Misc utilities (port of ``sonar_tpu.utils.misc``; reference
py/utils.py): ``fallback``, ``maybe_apply``, ``clamp_float``,
``filter_dict``, ``trunc_decimals``, ``adjust_slice``, ``crop_samples``,
``pattern_break``, ``elementwise_shuffle_by_dim``, the two step-from-sigma
helpers that wavelet CFG uses; and the port's own ``host_sigma``,
default-device rule and ``work_dtype``."""

from __future__ import annotations

from typing import Callable, Sequence

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


def trunc_decimals(x: torch.Tensor, decimals: int = 3) -> torch.Tensor:
    """py/utils.py:660-664 — truncate (toward zero) to N decimals."""
    x_i = torch.trunc(x)
    scale = 10.0**decimals
    return x_i + torch.trunc((x - x_i) * scale) * (1.0 / scale)


def adjust_slice(s: slice, size: int, offset: int) -> slice:
    """py/utils.py:513-523 — shift a slice by a clamped offset."""
    if offset == 0:
        return s
    start = s.start if s.start is not None else 0
    stop = s.stop if s.stop is not None else size
    if offset < 0:
        adj = min(start, abs(offset))
        return slice(start - adj, stop - adj)
    adj = min(size - stop, offset)
    return slice(start + adj, stop + adj)


def crop_samples(tensor: torch.Tensor, width: int, height: int, *, mode: str = "center",
                 offset_width: int = 0, offset_height: int = 0) -> torch.Tensor:
    """9-anchor crop with clamped offsets (py/utils.py:526-568): ``mode`` is
    ``center`` or ``<top|center|bottom>_<left|center|right>``."""
    if tensor.ndim < 3:
        raise ValueError("Can only handle >= 3 dimensional tensors")
    th, tw = tensor.shape[-2:]
    if (tw, th) == (width, height):
        return tensor
    if tw < width or th < height:
        raise ValueError("Can't crop sample smaller than requested width or height")
    if mode == "center":
        hmode = wmode = "center"
    else:
        hmode, wmode, *extra = mode.split("_")
        if extra:
            raise ValueError("Bad composite mode")
    starts = {"top": 0, "left": 0, "bottom": th - height, "right": tw - width}
    if hmode not in ("top", "center", "bottom"):
        raise ValueError("Bad height mode in composite mode")
    if wmode not in ("left", "center", "right"):
        raise ValueError("Bad width mode in composite mode")
    h0 = (th - height) // 2 if hmode == "center" else starts[hmode]
    w0 = (tw - width) // 2 if wmode == "center" else starts[wmode]
    wslice = adjust_slice(slice(w0, w0 + width), tw, offset_width)
    hslice = adjust_slice(slice(h0, h0 + height), th, offset_height)
    return tensor[..., hslice, wslice]


def pattern_break(noise: torch.Tensor, *, percentage: float = 0.5, detail_level: float = 0.0,
                  restore_scale: bool = True,
                  blend_function: Callable | None = None) -> torch.Tensor:
    """Remainder-hash + erfinv pattern scrambler (py/utils.py:576-596), in
    float32 and rounded once to the input's type. The range is restored
    from 0-dim device tensors: nothing is read back."""
    from ..core.blend import BLENDING_MODES
    from ..core.normalize import normalize_to_scale

    blend_function = fallback(blend_function, BLENDING_MODES["lerp"])
    x = noise.to(torch.float32)
    noise_normed = normalize_to_scale(x, -1.0, 1.0, dim=None)
    result = torch.remainder(torch.abs(noise_normed) * 1000000, 11) / 11
    result = torch.clamp((1 + detail_level / 10) * torch.erfinv(2 * result - 1)
                         * (2**0.5) * 0.2, -1, 1)
    if restore_scale:
        result = normalize_to_scale(result, x.min(), x.max(), dim=None)
    return blend_function(x, result, percentage).to(noise.dtype)


def elementwise_shuffle_by_dim(t: torch.Tensor, seed: int, *, dim: int = -1,
                               prob: float = 1.0, no_identity: bool = False) -> torch.Tensor:
    """Per-position shuffle along one axis (py/utils.py:599-657), drawn on
    the device: each line along ``dim`` is shuffled with probability
    ``prob`` by a permutation that is the ``argsort`` of Philox uniforms
    (kernel B3), or, with ``no_identity``, by a cyclic shift of 1 to n-1
    (a derangement), ``1 + floor(u·(n-1))`` of one uniform a line."""
    from ..core.rng import derive_seed
    from ..kernels.hwrng import philox_rand

    dim = dim % t.ndim
    moved = torch.movedim(t, dim, -1)
    lead, n = moved.shape[:-1], moved.shape[-1]
    flat = moved.reshape(-1, n)
    p = flat.shape[0]
    base = torch.arange(n, device=t.device).expand(p, n)
    mask = (philox_rand(derive_seed(seed, "mask"), (p,), device=t.device) < prob
            if prob < 1.0 else None)
    if no_identity:
        u = philox_rand(derive_seed(seed, "perm"), (p,), device=t.device)
        offsets = torch.floor(u * (n - 1)).to(torch.int64) + 1
        perms = (base + offsets[:, None]) % n
    else:
        u = philox_rand(derive_seed(seed, "perm"), (p, n), device=t.device)
        perms = torch.argsort(u, dim=1, stable=True)
    if mask is not None:
        perms = torch.where(mask[:, None], perms, base)
    shuffled = torch.gather(flat, 1, perms)
    return torch.movedim(shuffled.reshape(*lead, n), -1, dim)


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


# the JAX package's name: the port computes its traced arithmetic on the host
# and returns ``None`` where JAX returns ``valid == False``
step_from_sigmas_traced = step_from_sigmas_f32
