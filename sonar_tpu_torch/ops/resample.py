"""Spatial resampling (port of ``sonar_tpu.ops.resample``; the reference's
``scale_samples``, py/utils.py:58-67, with comfy.utils.common_upscale method
semantics).

Every separable method is two precomputed interpolation matrices,
``out = W_h @ x @ W_w^T``, built on the host with numpy by the same code as
the JAX package (so the two index and weigh alike), cached as device tensors
per (in, out, mode, device, dtype). ``F.interpolate`` is not used: its
nearest and area conventions differ from ``_resize_matrix``'s.
An upscaling matrix has at most four nonzeros a row; ``resize_taps`` gives
them as padded sparse rows, the form kernel B4 gathers from.

- ``bilinear``/``bicubic``: half-pixel source coordinates, border-clamped
  taps; bicubic is Keys with a = -0.75.
- ``nearest``: the legacy floor mapping; ``nearest-exact``: half-pixel
  centres.
- ``area`` == ``adaptive_avg_pool2d`` (variable-width bins).
- ``bislerp``: comfy's spherical bilinear over the channel axis, a 2-tap
  gather + slerp per axis.

The products run in float32 under torch's default matmul precision (no
TF32 unless a caller turns ``torch.backends.cuda.matmul.allow_tf32`` on).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

UPSCALE_METHODS = (
    "bilinear",
    "nearest-exact",
    "nearest",
    "area",
    "bicubic",
    "bislerp",
    "adaptive_avg_pool2d",
)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix."""
    I, O = in_size, out_size
    W = np.zeros((O, I), dtype=np.float64)
    if mode == "nearest":
        src = np.minimum((np.arange(O) * I) // O, I - 1)
        W[np.arange(O), src] = 1.0
    elif mode == "nearest-exact":
        src = np.minimum(((np.arange(O) + 0.5) * I / O).astype(np.int64), I - 1)
        W[np.arange(O), src] = 1.0
    elif mode == "bilinear":
        x = (np.arange(O) + 0.5) * I / O - 0.5
        x0 = np.floor(x).astype(np.int64)
        f = x - x0
        for tap, w in ((x0, 1.0 - f), (x0 + 1, f)):
            np.add.at(W, (np.arange(O), np.clip(tap, 0, I - 1)), w)
    elif mode == "bicubic":
        x = (np.arange(O) + 0.5) * I / O - 0.5
        x0 = np.floor(x).astype(np.int64)
        f = x - x0
        for k in (-1, 0, 1, 2):
            w = _cubic_kernel(f - k)
            np.add.at(W, (np.arange(O), np.clip(x0 + k, 0, I - 1)), w)
    elif mode in ("area", "adaptive_avg_pool2d"):
        for o in range(O):
            lo = (o * I) // O
            hi = -(-((o + 1) * I) // O)  # ceil
            W[o, lo:hi] = 1.0 / (hi - lo)
    else:
        raise ValueError(f"Unknown separable resize mode {mode!r}")
    return W.astype(np.float32)


def resize_matrix(in_size: int, out_size: int, mode: str, *, device,
                  dtype=torch.float32, transpose: bool = False) -> torch.Tensor:
    """``_resize_matrix`` (or its transpose) as a contiguous device tensor,
    uploaded once per (in, out, mode, device, dtype, transpose)."""
    return _device_matrix(in_size, out_size, mode, torch.device(device), dtype, transpose)


@lru_cache(maxsize=256)
def _device_matrix(in_size, out_size, mode, device, dtype, transpose):
    m = _resize_matrix(in_size, out_size, mode)
    m = torch.from_numpy(np.ascontiguousarray(m.T if transpose else m))
    return m.to(device=device, dtype=dtype)


@lru_cache(maxsize=256)
def _resize_taps(in_size: int, out_size: int, mode: str, taps: int | None = None):
    """``_resize_matrix(in_size, out_size, mode)`` as padded sparse rows:
    ``idx`` (out_size, T) int32 and ``val`` (out_size, T) float32, the
    nonzero columns of each row in ascending order and their weights, the
    matrix's own bytes. ``T`` is the largest count of nonzeros in a row (1
    nearest, 2 bilinear and upscaling area, up to 4 bicubic), or ``taps``
    where given (at least that count); a shorter row repeats its last
    column with weight 0. Derived from the dense matrix, so every mode and
    every ragged size is served."""
    m = _resize_matrix(in_size, out_size, mode)
    nz = m != 0
    count = nz.sum(axis=1)
    t = max(1, int(count.max()))
    if taps is not None:
        if taps < t:
            raise ValueError(f"{mode} {in_size}->{out_size} has rows of {t} taps, not {taps}")
        t = taps
    # a stable sort on "is zero" lists each row's nonzero columns first, ascending
    idx = np.argsort(~nz, axis=1, kind="stable")[:, :min(t, in_size)]
    idx = np.pad(idx, ((0, 0), (0, t - idx.shape[1])))
    val = np.take_along_axis(m, idx, axis=1)
    pad = np.arange(t)[None, :] >= count[:, None]
    last = np.take_along_axis(idx, np.maximum(count - 1, 0)[:, None], axis=1)
    idx = np.where(pad, last, idx).astype(np.int32)
    val = np.where(pad, np.float32(0.0), val).astype(np.float32)
    return idx, val


def resize_taps(in_size: int, out_size: int, mode: str, *, device, taps: int | None = None):
    """``_resize_taps`` as contiguous device tensors ``(idx, val)``, uploaded
    once per (in, out, mode, taps, device)."""
    return _device_taps(in_size, out_size, mode, taps, torch.device(device))


@lru_cache(maxsize=256)
def _device_taps(in_size, out_size, mode, taps, device):
    idx, val = _resize_taps(in_size, out_size, mode, taps)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(val).to(device))


def _resize_separable(samples: torch.Tensor, width: int, height: int,
                      mode: str) -> torch.Tensor:
    h, w = samples.shape[-2], samples.shape[-1]
    out = samples
    if h != height:
        Wh = resize_matrix(h, height, mode, device=samples.device, dtype=samples.dtype)
        out = torch.einsum("oh,...hw->...ow", Wh, out)
    if w != width:
        Ww = resize_matrix(w, width, mode, device=samples.device, dtype=samples.dtype)
        out = torch.einsum("pw,...hw->...hp", Ww, out)
    return out


def _slerp_vectors(v0: torch.Tensor, v1: torch.Tensor, t: torch.Tensor, *,
                   channel_axis: int, eps: float = 1e-8) -> torch.Tensor:
    """Per-position slerp of channel vectors (comfy bislerp inner op)."""
    n0 = torch.sqrt(torch.sum(v0 * v0, dim=channel_axis, keepdim=True)) + eps
    n1 = torch.sqrt(torch.sum(v1 * v1, dim=channel_axis, keepdim=True)) + eps
    u0, u1 = v0 / n0, v1 / n1
    dot = torch.clamp(torch.sum(u0 * u1, dim=channel_axis, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = torch.abs(so) > 1e-6
    so_safe = torch.where(safe, so, torch.ones_like(so))
    w0 = torch.where(safe, torch.sin((1.0 - t) * omega) / so_safe, 1.0 - t)
    w1 = torch.where(safe, torch.sin(t * omega) / so_safe, t)
    res = u0 * w0 + u1 * w1
    norm = n0 * (1.0 - t) + n1 * t
    return res * norm


def _bislerp_axis(x: torch.Tensor, out_size: int, axis: int,
                  channel_axis: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    coords = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    i0 = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    frac = np.clip(coords - np.floor(coords), 0.0, 1.0).astype(np.float32)
    v0 = torch.index_select(x, axis, torch.from_numpy(i0).to(x.device))
    v1 = torch.index_select(x, axis, torch.from_numpy(i1).to(x.device))
    tshape = [1] * x.ndim
    tshape[axis] = out_size
    t = torch.from_numpy(frac).to(device=x.device, dtype=x.dtype).reshape(tshape)
    return _slerp_vectors(v0, v1, t, channel_axis=channel_axis)


def scale_samples(samples: torch.Tensor, width: int, height: int, *,
                  mode: str = "bicubic") -> torch.Tensor:
    """Resize (..., H, W) → (..., height, width). NCHW assumed for bislerp
    (channel axis = -3), matching comfy.utils.common_upscale."""
    if samples.shape[-2] == height and samples.shape[-1] == width:
        return samples
    if mode == "bislerp":
        out = _bislerp_axis(samples, width, axis=-1, channel_axis=-3)
        return _bislerp_axis(out, height, axis=-2, channel_axis=-3)
    return _resize_separable(samples, width, height, mode)
