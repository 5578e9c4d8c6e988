"""Spans from the benchmark's own files, and the reduction of a
``torch.profiler`` trace of whole calls into what the per-layer metrics
read.

Spans: ``record_function("image")`` around each pipeline call (its closing
synchronisation included) and ``record_function("denoiser")`` around each
model callable handed to the pipeline. A device operation belongs to the
span that was open when the host launched it: the launch is the CUDA
runtime or driver call with the operation's correlation id. Events stay
in memory; only the summary leaves this module.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

SPANS = ("image", "denoiser")


class Spans:
    """The run's spans and counts: off, they cost nothing and wrap nothing."""

    def __init__(self, enabled: bool, forward_flops):
        self.enabled = enabled
        self.forward_flops = forward_flops
        self.reset()

    def reset(self):
        self.calls = 0
        self.flops = 0.0

    def denoiser(self, fn):
        if not self.enabled:
            return fn

        def traced(x, sigma, **kw):
            with torch.profiler.record_function("denoiser"):
                self.calls += 1
                self.flops += self.forward_flops(tuple(x.shape))
                return fn(x, sigma, **kw)

        return traced

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.enabled else contextlib.nullcontext()


class Profiler:
    """``torch.profiler`` over the traced calls, recording the device's
    activity, the CUDA runtime's launches and the benchmark's own spans, and
    no operator of the program: recording every operator (torch.profiler's
    default) costs the host ~15–20 µs a kernel, which would read as the
    device's idle time."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity

        self.acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())

    def __enter__(self):
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState, _enable_profiler,
                                    _prepare_profiler)

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        _prepare_profiler(config, self.acts)
        _enable_profiler(config, self.acts, {RecordScope.USER_SCOPE})
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler

        self.events = _disable_profiler().events()
        return False


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)."""
    return name.startswith("cuda") or name.startswith("cuLaunch") or name.startswith("cuMem")


def _short(kernel: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut][:80]


class _Intervals:
    """Sorted, disjoint ``[start, end)`` intervals: which one holds ``t``."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def index(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return i if i >= 0 and t < self.spans[i][1] else None


def summarize(events) -> dict:
    """The traced calls, from the profiler's raw events
    (``prof.profiler.kineto_results.events()``): each device operation
    launched inside an ``image`` span with its name, kind, seconds and
    whether a ``denoiser`` span held its launch; the device's busy seconds
    (the union of the operations) and the spans' wall seconds; the idle gaps
    inside the spans, each named by where the operation that ends it was
    launched (``denoiser`` or ``sampler``) and by that operation: the host
    was on its way to launching it."""
    cpu = torch.autograd.DeviceType.CPU
    spans = {k: [] for k in SPANS}
    launches, device = {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if e.is_user_annotation():
                if name in spans:
                    spans[name].append((e.start_ns(), e.end_ns()))
            elif _is_launch(name):
                launches[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation() and name not in spans:
            device.append(e)
    images, denoiser = _Intervals(spans["image"]), _Intervals(spans["denoiser"])
    kept, unattributed = [], 0
    for e in device:
        t = launches.get(e.correlation_id())
        if t is None:
            unattributed += 1
            continue
        img = images.index(t)
        if img is None:
            continue
        name = e.name()
        kind = ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernel")
        kept.append({"name": name, "kind": kind, "img": img,
                     "start": e.start_ns(), "end": e.start_ns() + e.duration_ns(),
                     "in_denoiser": denoiser.index(t) is not None})
    per_image = defaultdict(list)
    for k in kept:
        per_image[k["img"]].append(k)
    busy_ns, gaps = 0, defaultdict(float)
    for img, (s0, s1) in enumerate(images.spans):
        cur = s0
        for k in sorted(per_image[img], key=lambda k: k["start"]):
            a, b = max(k["start"], s0), min(k["end"], s1)
            if a > cur:
                where = "denoiser" if k["in_denoiser"] else "sampler"
                gaps[f"{where}:{_short(k['name'])}"] += (a - cur) / 1e9
            if b > cur:
                busy_ns += b - max(a, cur)
                cur = b
        if s1 > cur:
            gaps["image end:synchronize"] += (s1 - cur) / 1e9
    by_name = defaultdict(float)
    for k in kept:
        by_name[k["name"]] += (k["end"] - k["start"]) / 1e9
    return {
        "ops": kept,
        "busy_s": busy_ns / 1e9,
        "window_s": sum(b - a for a, b in images.spans) / 1e9,
        "images": len(images.spans),
        "denoiser_spans": len(spans["denoiser"]),
        "unattributed": unattributed,
        "launches": len(launches),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }
