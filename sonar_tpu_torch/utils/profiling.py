"""The verbose channel of wavelet CFG's rule dump (port of part of
``sonar_tpu.utils.profiling``): plain ``print`` by default, any callable
through :func:`set_verbose_sink`. ``StepTimer`` and ``trace`` are not
ported yet."""

from __future__ import annotations

from typing import Callable

_VERBOSE_SINK: Callable[[str], None] = print


def set_verbose_sink(fn: Callable[[str], None]) -> None:
    global _VERBOSE_SINK
    _VERBOSE_SINK = fn


def verbose_writer(msg: str) -> None:
    _VERBOSE_SINK(msg)
