"""Small helpers (port of ``sonar_tpu.utils``): part of ``utils/misc.py``
and the verbose channel of ``utils/profiling.py``."""

from .misc import (clamp_float, fallback, filter_dict, maybe_apply, step_from_sigmas,
                   step_from_sigmas_f32)
from .profiling import set_verbose_sink, verbose_writer

__all__ = [
    "clamp_float",
    "fallback",
    "filter_dict",
    "maybe_apply",
    "set_verbose_sink",
    "step_from_sigmas",
    "step_from_sigmas_f32",
    "verbose_writer",
]
