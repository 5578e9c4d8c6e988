"""Wavelet facade and pyramid utilities (port of ``sonar_tpu.wavelets.api``;
reference py/wavelet_functions.py).

:class:`Wavelet` mirrors the reference wrapper surface (forward, inverse,
two-step inverse, separate inverse wave and mode) over the port's DWT and
DTCWT. ``biort``/``qshift`` select named DTCWT banks (the published tables
of :mod:`.kingsbury`; reference surface py/wavelet_functions.py:62-101).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils.misc import fallback
from .coeffs import get_wavelet
from .coeffs import wavelist as _wavelist
from .dtcwt import _resolve_level1, _resolve_qshift, dtcwt2d, idtcwt2d
from .dwt import dwt1d, dwt2d, idwt1d, idwt2d


class Wavelet:
    DEFAULT_MODE = "symmetric"
    DEFAULT_LEVEL = 3
    DEFAULT_WAVE = "db4"

    def __init__(
        self,
        *,
        wave: str = DEFAULT_WAVE,
        level: int = DEFAULT_LEVEL,
        mode: str = DEFAULT_MODE,
        use_1d_dwt: bool = False,
        use_dtcwt: bool = False,
        biort: str = "near_sym_a",
        qshift: str = "qshift_a",
        inv_wave: str | None = None,
        inv_mode: str | None = None,
        inv_biort: str | None = None,
        inv_qshift: str | None = None,
        device=None,
    ):
        del device
        self.wave = wave
        self.level = level
        self.mode = mode
        self.use_1d_dwt = use_1d_dwt
        self.use_dtcwt = use_dtcwt
        self.biort = biort
        self.qshift = qshift
        self.inv_wave = fallback(inv_wave, wave)
        self.inv_mode = fallback(inv_mode, mode)
        self.inv_biort = fallback(inv_biort, biort)
        self.inv_qshift = fallback(inv_qshift, qshift)
        if not use_dtcwt:
            get_wavelet(self.wave)  # validate eagerly
            get_wavelet(self.inv_wave)
        else:
            for b in (self.biort, self.inv_biort):
                _resolve_level1(b)  # validate eagerly
            for q in (self.qshift, self.inv_qshift):
                _resolve_qshift(q)
        self._fwd_shape = None

    def forward(self, t: torch.Tensor, *, forward_function: Callable | None = None):
        if forward_function is not None:
            return forward_function(t)
        self._fwd_shape = t.shape
        if self.use_dtcwt:
            yls, yhs = dtcwt2d(t, self.level, biort=self.biort, qshift=self.qshift)
            # yl carries the 4 tree lowpasses stacked on a leading axis, so the
            # (yl, yh) pyramid protocol (scaling, blend) applies unchanged
            return torch.stack(yls, dim=0), yhs
        if self.use_1d_dwt:
            return dwt1d(t, self.wave, self.level, self.mode)
        return dwt2d(t, self.wave, self.level, self.mode)

    def inverse(
        self,
        yl: torch.Tensor,
        yh,
        *,
        inverse_function: Callable | None = None,
        two_step_inverse: bool = False,
        out_shape: tuple | None = None,
    ) -> torch.Tensor:
        out_shape = fallback(out_shape, self._fwd_shape)
        if inverse_function is not None:
            inv = inverse_function
        elif self.use_dtcwt:
            inv = lambda pair: idtcwt2d(  # noqa: E731
                tuple(pair[0][i] for i in range(4)), pair[1],
                out_hw=None if out_shape is None else tuple(out_shape[-2:]),
                biort=self.inv_biort, qshift=self.inv_qshift)
        elif self.use_1d_dwt:
            inv = lambda pair: idwt1d(  # noqa: E731
                pair[0], pair[1], self.inv_wave, self.inv_mode,
                out_len=None if out_shape is None else out_shape[-1])
        else:
            inv = lambda pair: idwt2d(  # noqa: E731
                pair[0], pair[1], self.inv_wave, self.inv_mode,
                out_hw=None if out_shape is None else tuple(out_shape[-2:]))
        if not two_step_inverse:
            return inv((yl, yh))
        # inverse lows and highs separately, then sum (py/wavelet_functions.py:96-106)
        highs = inv((torch.zeros_like(yl), yh))
        lows = inv((yl, tuple(torch.zeros_like(b) for b in yh)))
        return highs + lows

    @staticmethod
    def wavelist() -> tuple:
        return _wavelist()

    @staticmethod
    def modelist() -> tuple:
        return ("symmetric", "zero", "reflect", "replicate", "periodization",
                "periodic", "constant")


def _is_scalar(v) -> bool:
    return isinstance(v, (float, int)) or isinstance(v, torch.Tensor)


def expand_yh_scales(yh: Sequence, *, yh_scales=1.0):
    """Normalize yh scale specs to per-band, per-orientation tuples
    (py/wavelet_functions.py:148-190), the single ``"fill"`` replicator
    included. Python numbers become floats; tensors pass through."""
    yhlen = len(yh)
    yh_shape = yh[0].shape
    olen = yh_shape[2] if len(yh_shape) > 3 else 1

    def _num(v):
        return float(v) if isinstance(v, (float, int)) else v

    if _is_scalar(yh_scales):
        return ((_num(yh_scales),) * olen,) * yhlen
    otemplate = (1.0,) * olen
    yh_scales = tuple(
        (_num(band),) * olen
        if _is_scalar(band)
        else (
            (*(_num(i) for i in band[:olen]), *otemplate[: olen - len(band[:olen])])
            if isinstance(band, (tuple, list))
            else band
        )
        for band in yh_scales
    )
    if "fill" in yh_scales:
        fillidx = yh_scales.index("fill")
        if "fill" in yh_scales[fillidx + 1:]:
            raise ValueError("Only one fill allowed.")
        if fillidx == 0 or len(yh_scales) < 2:
            raise ValueError(
                "Invalid fill value, cannot be in the first position or the only item.")
        if len(yh_scales) - 1 < yhlen:
            fill = (yh_scales[fillidx - 1],) * (yhlen - (len(yh_scales) - 1))
            yh_scales = (*yh_scales[:fillidx], *fill, *yh_scales[fillidx + 1:])
        else:
            yh_scales = (*yh_scales[:fillidx], *yh_scales[fillidx + 1:])
    return yh_scales[:yhlen]


def _scale_band(ht: torch.Tensor, hscale) -> torch.Tensor:
    """One band times its scale: a number, or per orientation (dim 2 of a
    2D band, missing orientations 1.0; a 1D band takes the first). The
    scales are host numbers: one multiply when they agree, else one per
    orientation, and no tensor is made from them on the card."""
    if isinstance(hscale, (int, float)):
        return ht * hscale
    if ht.ndim <= 3:
        return ht * float(hscale[0])
    vals = [float(v) for v in hscale[: ht.shape[2]]]
    vals += [1.0] * (ht.shape[2] - len(vals))
    if all(v == vals[0] for v in vals):
        return ht * vals[0]
    return torch.cat([ht[:, :, i:i + 1] * v for i, v in enumerate(vals)], dim=2)


def wavelet_scaling(yl, yh, yl_scale, yh_scales, *, in_place: bool = False):
    """yl·yl_scale; per-band (and per-orientation, dim 2) yh multiplies
    (py/wavelet_functions.py:193-216). ``in_place`` is accepted and
    ignored: the bands are new tensors, as in the JAX package."""
    del in_place
    if not (isinstance(yl_scale, (int, float)) and yl_scale == 1.0):
        yl = yl * yl_scale
    scales = expand_yh_scales(yh, yh_scales=yh_scales if yh_scales is not None else 1.0)
    out_yh = [_scale_band(ht, hs) for hs, ht in zip(scales, yh)]
    out_yh.extend(yh[len(out_yh):])  # remaining bands unscaled
    return yl, tuple(out_yh)


def wavelet_blend(a, b, *, yl_factor, blend_function, yh_factor=None,
                  yh_blend_function=None):
    """Blend two (yl, yh) pyramids with separate yl/yh factors and functions
    (py/wavelet_functions.py:219-238)."""
    yh_factor = fallback(yh_factor, yl_factor)
    yh_blend_function = fallback(yh_blend_function, blend_function)
    return (
        blend_function(a[0], b[0], yl_factor),
        tuple(yh_blend_function(ta, tb, yh_factor) for ta, tb in zip(a[1], b[1])),
    )
