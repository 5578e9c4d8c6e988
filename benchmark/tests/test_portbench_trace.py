"""The trace's reduction and the per-layer readers on a made-up trace whose
answers are known: two denoiser calls and a sampler kernel inside one
``image`` span, and a kernel launched outside it."""

import pytest
import torch

from benchmark import trace
from benchmark.metrics import (denoiser_ms, device_idle_pct, kernels_per_step, kernels_roofline,
                               sonar_ms_per_step, step_mfu_pct)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
US = 1000  # ns


class Ev:
    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self._n, self._d, self._s, self._e, self._c, self._a = (name, device, start, end, corr,
                                                                annotation)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


def _events():
    ev = [Ev("image", CPU, 0, 1000 * US, annotation=True),
          Ev("denoiser", CPU, 10 * US, 200 * US, annotation=True),
          Ev("denoiser", CPU, 300 * US, 500 * US, annotation=True),
          Ev("image", CUDA, 0, 1000 * US, annotation=True)]  # the device's copy of the span
    launches = [(1, 20), (2, 30), (3, 310), (4, 600), (5, 2000)]
    ev += [Ev("cudaLaunchKernel", CPU, t * US, t * US + 5 * US, corr=c) for c, t in launches]
    ev += [Ev("gemm_kernel", CUDA, 100 * US, 300 * US, corr=1),     # denoiser, 200 us
           Ev("gemm_kernel", CUDA, 300 * US, 400 * US, corr=2),     # denoiser, 100 us
           Ev("gemm_kernel", CUDA, 450 * US, 550 * US, corr=3),     # denoiser, 100 us
           Ev("void momentum_step_kernel<float>(x)", CUDA, 700 * US, 710 * US, corr=4),
           Ev("gemm_kernel", CUDA, 2100 * US, 2200 * US, corr=5)]  # outside the image
    return ev


def test_portbench_summarize():
    s = trace.summarize(_events())
    assert s["images"] == 1 and s["denoiser_spans"] == 2 and s["unattributed"] == 0
    assert len(s["ops"]) == 4
    assert [k["in_denoiser"] for k in s["ops"]] == [True, True, True, False]
    assert s["busy_s"] == pytest.approx(410e-6)  # 100..400, 450..550, 700..710
    assert s["window_s"] == pytest.approx(1e-3)
    gaps = dict(s["idle_gaps"])
    assert gaps["denoiser:gemm_kernel"] == pytest.approx(150e-6)  # 0..100 and 400..450
    assert gaps["sampler:momentum_step_kernel"] == pytest.approx(150e-6)
    assert gaps["image end:synchronize"] == pytest.approx(290e-6)


def test_portbench_short_names():
    assert trace._short("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>"
                        "(long, float)") == "at::native::RowwiseMomentsCUDAKernel"
    assert trace._short("Memset (Device)") == "Memset "


def test_portbench_readers():
    spans = trace.Spans(False, lambda shape: 0.0)
    spans.calls, spans.flops = 2, 1e9
    run = {"trace": trace.summarize(_events()), "spans": spans, "steps": 1,
           "traffic": {"shape": [1, 4, 128, 128]}, "config": {"dtype": "float32"}}
    assert denoiser_ms.read(run) == pytest.approx(0.2)
    assert sonar_ms_per_step.read(run) == pytest.approx(0.01)
    assert kernels_per_step.read(run) == 4
    assert device_idle_pct.read(run) == pytest.approx(59.0)
    assert step_mfu_pct.read(run) == pytest.approx(1e9 / 1e-3 / 989.4e12 * 100)
    from benchmark.kernels import b1_momentum

    want = b1_momentum.least_seconds({"shape": [1, 4, 128, 128]}) / 10e-6 * 100
    assert kernels_roofline.read(run) == pytest.approx(want)


def test_portbench_readers_without_a_trace():
    run = {"trace": None, "spans": trace.Spans(False, None), "steps": 0}
    for m in (denoiser_ms, sonar_ms_per_step, kernels_per_step, device_idle_pct, step_mfu_pct,
              kernels_roofline):
        assert m.read(run) is None
