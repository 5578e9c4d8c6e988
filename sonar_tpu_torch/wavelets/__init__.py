"""Wavelet subsystem (port of ``sonar_tpu.wavelets``): filter banks, the
DWT and its inverse, and the reference's wavelet utility surface
(py/wavelet_functions.py). The dual-tree transform (``dtcwt.py``,
``kingsbury.py``) is not ported yet and is not imported here."""

from .api import Wavelet, expand_yh_scales, wavelet_blend, wavelet_scaling
from .coeffs import WaveletFilters, get_wavelet, wavelist
from .dwt import dwt1d, dwt2d, idwt1d, idwt2d

__all__ = [
    "Wavelet",
    "WaveletFilters",
    "dwt1d",
    "dwt2d",
    "expand_yh_scales",
    "get_wavelet",
    "idwt1d",
    "idwt2d",
    "wavelet_blend",
    "wavelet_scaling",
    "wavelist",
]
