"""Tracing and observability (port of ``sonar_tpu.utils.profiling``).

- :class:`StepTimer`: a sampler ``callback`` that records the wall time of
  each step and reports p50/p90/mean. It synchronises with the card when
  the step's latent lies there (``torch.cuda.synchronize``), so a step's
  time includes its device work; a CPU latent needs no synchronisation.
- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``).
- :func:`verbose_writer`: wavelet CFG's rule-dump channel (plain ``print``
  by default, any callable through :func:`set_verbose_sink`).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


class StepTimer:
    """Collects per-step latencies from a sampler callback."""

    def __init__(self, *, sync: bool = True):
        self.sync = sync
        self.times: list[float] = []
        self._last = None

    def __call__(self, info: dict) -> None:
        x = info.get("x")
        if self.sync and isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def start(self) -> None:
        self._last = time.perf_counter()

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),  # timed intervals (call start() for all steps)
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "mean_ms": float(arr.mean() * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``<logdir>/trace.json`` (a fresh temporary directory when ``logdir``
    is None); device activity too where there is a card. Yields the trace
    file's path."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="sonar_tpu_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


_VERBOSE_SINK: Callable[[str], None] = print


def set_verbose_sink(fn: Callable[[str], None]) -> None:
    global _VERBOSE_SINK
    _VERBOSE_SINK = fn


def verbose_writer(msg: str) -> None:
    _VERBOSE_SINK(msg)
