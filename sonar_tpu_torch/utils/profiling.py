"""Tracing and observability (port of ``sonar_tpu.utils.profiling``).

- :func:`span`: a named range around a layer's work, recorded only while a
  profiler records (``torch.profiler.profile``, :func:`trace`, or any
  other session of the autograd profiler). Off, a span site costs one
  check of that switch and returns one shared no-op context: no
  ``record_function``, no event, no allocation. On, it opens
  ``torch.profiler.record_function(name)``, so the range lies on the
  profiler's timeline beside the device operations launched inside it, and
  keeps a record of its time in this module's registry: a pair of CUDA
  events on the current stream where CUDA is initialised and the stream is
  not capturing a graph, the host clock otherwise.
- :func:`span_totals`: each span name's count and time since
  :func:`reset_spans` (which :func:`trace` calls on entry). Event timing
  on one stream measures a span from the end of the work queued before it
  to the end of its own work: where the host runs ahead of the device
  (a device-bound run) that is the device time of what the span launched,
  with the gaps between its launches; where the device waits for the host
  it also holds the stalls inside the span. Each timing event leaves the
  device idle for a few microseconds, so a span of that length reads well
  above its kernels' device time: read short spans from the profiler's
  trace, by the operations launched inside their range. A closed span's
  events are folded into its name's totals once the device has passed
  them, so the registry stays small over a long profiling session.
- :class:`StepTimer`: a sampler ``callback`` that records when each step
  ends and reports p50/p90/mean. On a card latent it records a CUDA event
  on the stream at each step, and :meth:`StepTimer.summary` synchronises
  once and reads the gaps between the events; a CPU latent (or
  ``sync=False``) reads the host clock.
- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``).
- :func:`verbose_writer`: wavelet CFG's rule-dump channel (plain ``print``
  by default, any callable through :func:`set_verbose_sink`).

The program's spans: ``sonar.step`` (a sampler step, its callback
outside), ``sonar.model`` (one call of the network), ``sonar.guidance`` (a
guided denoiser call, its model calls nested), ``sonar.noise`` (one noise
draw) and ``sonar.attention`` (the attention core: logits, softmax, the
value product).
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


_OFF = contextlib.nullcontext()
_FOLD_EVERY = 1024
_totals: dict[str, list] = {}  # name -> [count, ms], spans folded in
_pending: collections.deque = collections.deque()  # (name, start, end) events in flight
_epoch = 0  # bumped by reset_spans: a span opened before it is left out
_next_fold = _FOLD_EVERY


def _add(name: str, ms: float) -> None:
    t = _totals.setdefault(name, [0, 0.0])
    t[0] += 1
    t[1] += ms


def _fold(wait: bool) -> None:
    """Fold the pending event pairs into the totals, oldest first: each the
    device has passed, or every one after waiting for it."""
    global _next_fold
    while _pending and (wait or _pending[0][2].query()):
        name, start, end = _pending.popleft()
        end.synchronize()
        _add(name, start.elapsed_time(end))
    _next_fold = len(_pending) + _FOLD_EVERY


class _Span:
    """One span while the profiler records: its ``record_function`` range and
    its start mark, a CUDA event on ``stream`` or host seconds where
    ``stream`` is None."""

    __slots__ = ("name", "rf", "stream", "start", "epoch")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.epoch = _epoch
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self.stream = torch.cuda.current_stream()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        else:
            self.stream, self.start = None, time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            if self.epoch == _epoch:
                _add(self.name, (time.perf_counter() - self.start) * 1e3)
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            if self.epoch == _epoch:
                _pending.append((self.name, self.start, end))
                if len(_pending) >= _next_fold:
                    _fold(wait=False)
        return self.rf.__exit__(*exc)


def span(name: str):
    """A context manager over one layer's work, named ``name`` on the
    profiler's timeline and in :func:`span_totals`; a shared no-op while no
    profiler records."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def reset_spans() -> None:
    """Forget every span recorded so far (one still open is left out too)."""
    global _epoch, _next_fold
    _epoch += 1
    _totals.clear()
    _pending.clear()
    _next_fold = _FOLD_EVERY


def span_totals() -> dict:
    """``{name: {"count": n, "device_ms": total}}`` over the spans closed
    since :func:`reset_spans`. Where CUDA events are still pending it waits
    for the device, then reads them. The totals are left as they are, so
    several readers can call it in turn."""
    _fold(wait=True)
    return {name: {"count": n, "device_ms": ms} for name, (n, ms) in _totals.items()}


class StepTimer:
    """Collects per-step latencies from a sampler callback."""

    def __init__(self, *, sync: bool = True):
        self.sync = sync
        self.times: list[float] = []
        self._last = None
        self._events: list = []  # on one card: ``_device``
        self._device = None

    def __call__(self, info: dict) -> None:
        x = info.get("x")
        if self.sync and isinstance(x, torch.Tensor) and x.is_cuda:
            if x.device != self._device:  # events on two cards have no gap to read
                self._read_events()
                self._events, self._device = [], x.device
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(x.device))
            self._events.append(ev)
            return
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def start(self) -> None:
        """Mark the first step's start: on the host clock, and where CUDA is
        initialised with an event on the current card's stream. A latent on
        another card starts its own chain of events at its first step, and
        that step goes untimed."""
        self._last = time.perf_counter()
        if self.sync and torch.cuda.is_initialized():
            self._read_events()
            self._device = torch.device("cuda", torch.cuda.current_device())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            self._events = [ev]

    def _read_events(self) -> None:
        """Turn the recorded events into step times: one synchronisation,
        then the gaps between consecutive events."""
        if len(self._events) > 1:
            self._events[-1].synchronize()
            self.times.extend(a.elapsed_time(b) / 1e3
                              for a, b in zip(self._events, self._events[1:]))
        self._events = self._events[-1:]

    def summary(self) -> dict:
        self._read_events()
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
    file's path. The span registry is reset on entry, so
    :func:`span_totals` afterwards covers the same work as the trace."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="sonar_tpu_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    reset_spans()
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
