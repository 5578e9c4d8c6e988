"""Small helpers (port of ``sonar_tpu.utils``): ``utils/misc.py`` and
``utils/profiling.py`` (``span``, ``span_totals``, ``reset_spans``,
``StepTimer``, ``trace``, the verbose channel)."""

from .misc import (adjust_slice, clamp_float, crop_samples, elementwise_shuffle_by_dim,
                   fallback, filter_dict, maybe_apply, pattern_break, step_from_sigmas,
                   step_from_sigmas_f32, step_from_sigmas_traced, trunc_decimals)
from .profiling import (StepTimer, reset_spans, set_verbose_sink, span, span_totals, trace,
                        verbose_writer)

__all__ = [
    "StepTimer",
    "adjust_slice",
    "clamp_float",
    "crop_samples",
    "elementwise_shuffle_by_dim",
    "fallback",
    "filter_dict",
    "maybe_apply",
    "pattern_break",
    "reset_spans",
    "set_verbose_sink",
    "span",
    "span_totals",
    "step_from_sigmas",
    "step_from_sigmas_f32",
    "step_from_sigmas_traced",
    "trace",
    "trunc_decimals",
    "verbose_writer",
]
