"""The reader of the attention kernel's share (``attention_fused_pct``) on
made-up traces and ``span_totals()``, and where it finds nothing to read:
no trace, no attention span, a program without the kernel."""

import importlib.util

import pytest

from benchmark.metrics import attention_fused_pct
from sonar_tpu_torch.utils import profiling

SPANS = {"sonar.model": {"count": 60, "device_ms": 9570.0},
         "sonar.attention": {"count": 960, "device_ms": 7800.0}}
FFMA = "void (anonymous namespace)::attention_ffma_kernel<Ffma<40, 64, 32, 8> >(Args)"
TF32 = "void (anonymous namespace)::attention_tf32_kernel<Tf32<72, 2> >(Args)"
OTHER = "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>(float*)"


def _run(kernels, name=FFMA):
    ops = [{"name": name, "kind": "kernel"}] * kernels
    ops += [{"name": OTHER, "kind": "kernel"}, {"name": "Memcpy HtoD", "kind": "memcpy"}]
    return {"trace": {"ops": ops}}


@pytest.mark.parametrize("kernel, want", [(960, 100.0), (480, 50.0), (0, 0.0)])
def test_portbench_fused_share(monkeypatch, kernel, want):
    monkeypatch.setattr(profiling, "span_totals", lambda: SPANS)
    assert attention_fused_pct.read(_run(kernel)) == pytest.approx(want)


def test_portbench_fused_share_tf32(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: SPANS)
    assert attention_fused_pct.read(_run(960, TF32)) == pytest.approx(100.0)


@pytest.mark.parametrize("case", ["no trace", "no attention", "no kernel module"])
def test_portbench_fused_share_finds_nothing(monkeypatch, case):
    run = _run(960)
    monkeypatch.setattr(profiling, "span_totals", lambda: SPANS)
    if case == "no trace":
        run = {"trace": None}
    elif case == "no attention":
        monkeypatch.setattr(profiling, "span_totals", lambda: {"sonar.model": SPANS["sonar.model"]})
    else:  # the program before the kernel: attention spans, no kernel B7
        find_spec = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda n, *a: None if n.endswith("kernels.attention")
                            else find_spec(n, *a))
    assert attention_fused_pct.read(run) is None
