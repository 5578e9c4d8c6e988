"""One run of one cell: set-up, the measured window, the trace, and the
check against the plain reference. Everything cell-specific comes from the
files that ``BENCHMARK.json``'s entries name (see ``run.py``).

A run:

1. sets the configuration's precision switches, makes the weights on the
   device from ``--seed``, builds the program's denoisers on them
   (``families/<family>.py``) and a ``SonarPipeline`` from the traffic
   (``pipelines/<pipeline>.py``);
2. runs one warm-up call at the cell's own shape (every kernel the window
   launches is built and loaded then); ``setup_s`` ends here;
3. runs the window: calls one after another, each from its own seed, each
   ended by a synchronisation, until ``seconds`` have passed (and at least
   as many calls as the check needs); a CUDA event on the stream marks each
   call's start and each sampler step's end, recorded from the sampler's
   callback without a synchronisation;
   with ``trace`` the window is ``trace_calls`` whole calls under
   ``torch.profiler``;
4. reads the metrics, frees the program, and runs the reference over a
   sample of the window's calls drawn from the seed (``check.py``).
"""

from __future__ import annotations

import gc
import importlib
import json
import pathlib
import random
import time
import traceback

import torch

from . import check as checks
from . import traffic as traffic_mod
from . import weights
from .trace import Profiler, Spans, summarize

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


class _Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, the host's
    clock; ``ms(a, b)`` is the time between two marks, read after a sync."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def build(config: dict, traffic: dict, seed: int, device, spans: Spans):
    """The program under test: ``(pipeline, sigmas)``."""
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    ref = importlib.import_module(f"benchmark.reference.{config['family']}")
    params = weights.make(ref.param_specs(config), seed, device)
    models = family.build(config, params, traffic, device)
    models = {k: spans.denoiser(v) for k, v in models.items()}
    pipeline = importlib.import_module(f"benchmark.pipelines.{traffic['pipeline']}")
    return pipeline.build(models, traffic), traffic_mod.karras_sigmas(traffic)


def set_precision(config: dict) -> None:
    torch.backends.cudnn.allow_tf32 = bool(config["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["matmul_allow_tf32"])


def run_cell(name: str, *, seed: int, seconds: float, trace: bool, device, t_start: float,
             bench: dict | None = None, config: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None, log=print) -> dict:
    """One run of cell ``name``: the result line's fields. ``config``,
    ``traffic`` and ``limits`` replace the cell's files (the tests run the
    harness at small sizes on the CPU this way)."""
    bench = bench or load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    config = config or traffic_mod.load("configs", cell["config"])
    traffic = traffic or traffic_mod.load("traffic", cell["traffic"])
    limits = limits or traffic_mod.load("limits", name)
    cuda = torch.device(device).type == "cuda"
    set_precision(config)
    flops = importlib.import_module(f"benchmark.flops.{config['family']}")
    spans = Spans(trace, lambda shape: flops.forward_flops(config, shape))
    pipe, sigmas = build(config, traffic, seed, device, spans)
    clock = _Clock(device)
    sigma_max = float(sigmas[0])

    def call(index):
        s = traffic_mod.call_seed(seed, index)
        x0 = traffic_mod.start_latent(traffic, s, sigma_max, device)
        marks = [clock.mark()]
        with spans.span("image"):
            out = pipe(x0, sigmas, seed=s, callback=lambda info: marks.append(clock.mark()))
            clock.sync()
        return out, marks

    call("warm")
    clock.sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    n_check = int(traffic["check_calls"])
    outputs, step_ms, failed, error = [], [], 0, None
    prof = None
    if trace:
        spans.reset()
        prof = Profiler(cuda)
        prof.__enter__()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    index = 0
    while (index < n_check or time.perf_counter() < t_end) and not (
            trace and index >= int(traffic["trace_calls"])):
        try:
            out, marks = call(index)
        except Exception:  # a call that raises is a failed one; the run ends
            failed += 1
            error = f"call {index} raised:\n{traceback.format_exc()}"
            index += 1
            break
        outputs.append(out)
        step_ms.append(marks)
        index += 1
    clock.sync()
    window_s = time.perf_counter() - t0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = summarize(prof.events)
        del prof
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_ms = [clock.ms(m[k - 1], m[k]) for m in step_ms for k in range(1, len(m))]
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = {"setup_s": setup_s, "window_s": window_s, "steps": len(step_ms), "step_ms": step_ms, "peak_bytes": window_peak,
           "trace": summary, "spans": spans, "config": config, "traffic": traffic}
    metrics = read_metrics(bench, name, run, trace)

    # the check: a sample of the window's calls drawn from the seed
    rng = random.Random(traffic_mod.call_seed(seed, "check"))
    picked = sorted(rng.sample(range(len(outputs)), min(n_check, len(outputs))))
    compared = checks.compare(config, traffic, seed, sigmas,
                              [(i, outputs[i]) for i in picked], device, limits)
    bad = sum(1 for c in compared["per_call"] if not c["ok"])
    failed += bad
    correct = error is None and bad == 0
    result = {"correct": correct, "attempted": index, "failed": failed, "metrics": metrics,
              "device": device_info(device, cell["chips"], max(setup_peak, window_peak),
                                    summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": [[k, v] for k, v in summary["device_ops"]],
                               "idle_gaps": [[k, v] for k, v in summary["idle_gaps"]]}
        log(f"trace: {summary['images']} calls, {len(summary['ops'])} device operations, "
            f"{summary['denoiser_spans']} denoiser spans, {summary['launches']} launches seen, "
            f"{summary['unattributed']} operations unattributed")
    if error:
        log(error)
    result["checks"] = compared["checks"]
    return result


def read_metrics(bench: dict, name: str, run: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run), each from ``metrics/<name>.py``; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(device, chips: int, peak: int, summary) -> dict:
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info
