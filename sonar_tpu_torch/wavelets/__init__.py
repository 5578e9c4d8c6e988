"""Wavelet subsystem (port of ``sonar_tpu.wavelets``): filter banks, the
DWT and its inverse, and the reference's wavelet utility surface
(py/wavelet_functions.py), and the dual-tree complex wavelet transform
(``dtcwt.py``) with its published filter banks (``kingsbury.py``)."""

from .api import Wavelet, expand_yh_scales, wavelet_blend, wavelet_scaling
from .coeffs import WaveletFilters, get_wavelet, wavelist
from .dtcwt import dtcwt2d, idtcwt2d, qshift_filter
from .dwt import dwt1d, dwt2d, idwt1d, idwt2d

__all__ = [
    "Wavelet",
    "WaveletFilters",
    "dtcwt2d",
    "dwt1d",
    "dwt2d",
    "expand_yh_scales",
    "get_wavelet",
    "idtcwt2d",
    "idwt1d",
    "idwt2d",
    "qshift_filter",
    "wavelet_blend",
    "wavelet_scaling",
    "wavelist",
]
