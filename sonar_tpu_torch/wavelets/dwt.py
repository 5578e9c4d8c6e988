"""Separable 1D/2D DWT and its inverse in PyTorch (port of
``sonar_tpu.wavelets.dwt``; replaces pytorch_wavelets' DWTForward,
DWTInverse and DWT1D for the reference's wavelet CFG,
py/wavelet_functions.py:23-145). The layout is pytorch_wavelets':

- 2D forward: ``(yl, [yh_1, ..., yh_J])``, ``yh_j`` shaped
  ``(B, C, 3, H_j, W_j)`` in the orientation order (LH, HL, HH);
- 1D forward (3D latents): ``(yl, [yh_1, ..., yh_J])``, ``yh_j`` shaped
  ``(B, C, N_j)``.

Padding modes: zero, symmetric, reflect, replicate/constant, periodization,
periodic, with the JAX package's lengths, phase and crop offsets (so its
perfect reconstruction, exact for periodization and by synthesising at the
padded length and cropping for the padded modes).

No convolution. A filter bank is a gather that pads (a circular index for
periodization, a reflected one for ``symmetric``, which ``F.pad`` lacks),
an ``unfold`` of the taps' windows, one product with both filters at once
and one sum over the taps: exact float32 (or float64) products and sums on
every device. On the card, cuDNN would run a float32 convolution in TF32
unless told otherwise (``torch.backends.cudnn.allow_tf32`` is ``True`` by
default), ~1e-3 relative for an 8-tap db4 bank; the products and sums here
take no TF32 path, so the transform is the same under any setting of
those flags, and an analysis level is three kernels along each axis. The
synthesis is the JAX package's zero-stuffed full convolution
(``lhs_dilation=2``) written the same way. The taps and the pad indices are
made on the device once per (wave, device, dtype) and per (length, mode):
a call after the first copies nothing to the card and reads nothing back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .coeffs import WaveletFilters, get_wavelet

_MODES = ("zero", "constant", "replicate", "symmetric", "reflect", "periodic",
          "periodization")

# device constants, made once: (kind, ..., device, dtype) -> tensor
_CONSTANTS: dict = {}


def _resolve(wave) -> WaveletFilters:
    return wave if isinstance(wave, WaveletFilters) else get_wavelet(wave)


def _constant(key, make):
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = make()
    return t


def _bank(w: WaveletFilters, which: str, axis: int, device, dtype) -> torch.Tensor:
    """Both filters of ``which`` ("dec" or "rec"), reversed so a windowed
    product sum is a true convolution, shaped (2, 1, ..., 1, L) to meet
    windows of ``(..., 2, M, [W], L)``."""
    lo, hi = (w.dec_lo, w.dec_hi) if which == "dec" else (w.rec_lo, w.rec_hi)

    def make():
        t = torch.tensor([lo[::-1].tolist(), hi[::-1].tolist()], dtype=dtype)
        return t.reshape(2, *(1,) * -axis, len(lo)).to(device)

    return _constant((which, lo.tobytes(), hi.tobytes(), axis, str(device), dtype), make)


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each sample of the length-``n`` signal padded by
    (lo, hi), as ``jnp.pad`` pads (padding wider than the signal included)."""

    def make():
        i = torch.arange(-lo, n + hi)
        if mode in ("periodic", "periodization"):
            return (i % n).to(device)
        if mode in ("constant", "replicate"):
            return i.clamp(0, n - 1).to(device)
        if mode == "symmetric":
            i = i % (2 * n)
            return torch.where(i >= n, 2 * n - 1 - i, i).to(device)
        if mode == "reflect":
            if n == 1:
                return torch.zeros_like(i).to(device)
            i = i % (2 * n - 2)
            return torch.where(i >= n, 2 * n - 2 - i, i).to(device)
        raise ValueError(f"Unknown padding mode {mode!r}; valid: {', '.join(_MODES)}")

    return _constant(("pad", n, lo, hi, mode, str(device)), make)


def _pad(x: torch.Tensor, lo: int, hi: int, mode: str, axis: int) -> torch.Tensor:
    if lo == 0 and hi == 0:
        return x
    if mode == "zero":
        return F.pad(x, (0, 0) * (-axis - 1) + (lo, hi))
    return x.index_select(axis, _pad_index(x.shape[axis], lo, hi, mode, x.device))


def _afb(x: torch.Tensor, w: WaveletFilters, mode: str, axis: int) -> torch.Tensor:
    """Analysis filter bank along ``axis`` (-1 or -2): ``(..., N, [W])`` →
    ``(..., 2, M, [W])``, lowpass then highpass on the new axis.

    Phase-1 downsampling (pywt convention): coefficient i sees the window
    [2i+1, 2i+1+L) of the (L-1, L-1)-padded signal, giving pywt lengths
    floor((N+L-1)/2) for padded modes and N/2 for periodization."""
    L = w.filt_len
    n = x.shape[axis]
    if mode == "periodization":
        if n % 2:
            x = torch.cat([x, x.narrow(axis, n - 1, 1)], dim=axis)
            n += 1
        keep = n // 2
    else:
        keep = (n + L - 1) // 2
    xp = _pad(x, L - 1, L - 1, mode, axis)
    if L > 1:
        xp = xp.narrow(axis, 1, xp.shape[axis] - 1)
    win = xp.unfold(axis, L, 2).narrow(axis - 1, 0, keep)
    return (win.unsqueeze(axis - 2) * _bank(w, "dec", axis, x.device, x.dtype)).sum(-1)


def _sfb(pair: torch.Tensor, w: WaveletFilters, mode: str, axis: int,
         out_len: int) -> torch.Tensor:
    """Synthesis filter bank along ``axis``: ``(..., 2, M, [W])`` (the two
    bands on the axis before) → ``(..., out_len, [W])``. The full
    convolution of the zero-stuffed bands with the rec filters, bands
    summed: z[k] = Σ_i lo[i]·rec_lo[k−2i] + hi[i]·rec_hi[k−2i], cropped as
    the JAX package crops it."""
    L = w.filt_len
    start = L - 2 if L > 2 else 0
    if mode == "periodization":
        p = max(1, (L + 1) // 2)
        pair = pair.index_select(axis, _pad_index(pair.shape[axis], p, p, mode, pair.device))
        start += 2 * p
    m = pair.shape[axis]
    shape = list(pair.shape)
    shape[axis] = 2 * m - 1 + 2 * (L - 1)
    up = pair.new_zeros(shape)
    up.narrow(axis, L - 1, 2 * m - 1)[(slice(None),) * (pair.ndim + axis) + (slice(None, None, 2),)] = pair
    win = up.unfold(axis, L, 1)
    # a slice that runs past the end stops there, as the JAX package's does
    # (an inverse in a padded mode of a periodization analysis)
    win = win.narrow(axis - 1, start, min(out_len, win.shape[axis - 1] - start))
    return (win * _bank(w, "rec", axis, pair.device, pair.dtype)).sum((axis - 2, -1))


def _coeff_len(n: int, L: int, mode: str) -> int:
    if mode == "periodization":
        return (n + 1) // 2
    return (n + L - 1) // 2


def _ideal_len(out_len: int, remaining: int, L: int, mode: str) -> int:
    """Length the signal had ``remaining`` levels deep during analysis."""
    n = out_len
    for _ in range(remaining):
        n = _coeff_len(n, L, mode)
    return n


def _afb2d(x: torch.Tensor, w: WaveletFilters, mode: str, w_rows: WaveletFilters | None = None):
    """One 2D analysis level: ``(ll, bands)``, ``bands`` shaped (B, C, 3, H', W')
    in the order (LH, HL, HH). ``w`` filters along W, ``w_rows`` (default
    ``w``) along H, as the dual tree's mixed banks need."""
    # along W: (B, C, H, 2, Mw) → bands first (B, C, 2, H, Mw); along H:
    # (B, C, 2w, 2h, Mh, Mw), whose four (w, h) bands are LL, LH, HL, HH
    out = _afb(_afb(x, w, mode, -1).movedim(-2, -3), w_rows or w, mode, -2)
    out = out.reshape(*out.shape[:-4], 4, *out.shape[-2:])
    return out[..., 0, :, :], out[..., 1:, :, :]


def _sfb2d(ll: torch.Tensor, bands: torch.Tensor, w: WaveletFilters, mode: str, out_hw,
           w_rows: WaveletFilters | None = None) -> torch.Tensor:
    """Inverse of :func:`_afb2d` at one level, to ``out_hw``."""
    bh, bw = bands.shape[-2:]
    quad = torch.cat([ll.unsqueeze(-3), bands], dim=-3)
    quad = quad.reshape(*quad.shape[:-3], 2, 2, bh, bw)
    lo_hi = _sfb(quad, w_rows or w, mode, -2, out_hw[0]).movedim(-3, -2)
    return _sfb(lo_hi, w, mode, -1, out_hw[1])


def dwt1d(x: torch.Tensor, wave="db4", level: int = 3, mode: str = "symmetric"):
    """Multi-level 1D DWT over the last axis of (B, C, N)."""
    w = _resolve(wave)
    yl, yh = x, []
    for _ in range(level):
        out = _afb(yl, w, mode, -1)
        yl = out[..., 0, :]
        yh.append(out[..., 1, :])
    return yl, yh


def idwt1d(yl: torch.Tensor, yh, wave="db4", mode: str = "symmetric", out_len=None):
    """Inverse of :func:`dwt1d`; ``out_len`` crops to the original length."""
    w = _resolve(wave)
    x = yl
    for j, hi in enumerate(reversed(yh)):
        if x.shape[-1] != hi.shape[-1]:
            x = x[..., : hi.shape[-1]]
        if mode == "periodization" or not out_len:
            target = hi.shape[-1] * 2
        else:
            target = _ideal_len(out_len, len(yh) - 1 - j, w.filt_len, mode)
        x = _sfb(torch.stack([x, hi], dim=-2), w, mode, -1, target)
    if out_len is not None:
        x = x[..., :out_len]
    return x


def dwt2d(x: torch.Tensor, wave="db4", level: int = 3, mode: str = "symmetric"):
    """Multi-level 2D DWT of (B, C, H, W) → (yl, [yh_1 ... yh_J])."""
    w = _resolve(wave)
    yl, yh = x, []
    for _ in range(level):
        yl, bands = _afb2d(yl, w, mode)
        yh.append(bands)
    return yl, yh


def idwt2d(yl: torch.Tensor, yh, wave="db4", mode: str = "symmetric", out_hw=None):
    """Inverse of :func:`dwt2d`. ``out_hw`` crops to the original spatial
    size (required for non-periodization modes with odd sizes)."""
    w = _resolve(wave)
    L = w.filt_len
    x = yl
    for j, bands in enumerate(reversed(yh)):
        bh, bw = bands.shape[-2], bands.shape[-1]
        if x.shape[-2:] != (bh, bw):
            x = x[..., :bh, :bw]
        remaining = len(yh) - 1 - j
        if out_hw is not None:
            th = _ideal_len(out_hw[0], remaining, L, mode)
            tw = _ideal_len(out_hw[1], remaining, L, mode)
        else:
            th, tw = bh * 2, bw * 2
        x = _sfb2d(x, bands, w, mode, (th, tw))
    if out_hw is not None:
        x = x[..., : out_hw[0], : out_hw[1]]
    return x
