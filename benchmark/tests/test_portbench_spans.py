"""The reader of the program's spans (``attention_ms``) on a made-up
``span_totals()``, and where it finds nothing to read: no trace, a span
that did not run, a program without spans of its own."""

import pytest

from benchmark.metrics import attention_ms
from sonar_tpu_torch.utils import profiling

# one guided call a step over 30 steps, two model calls in each, 16
# attention blocks a model call
TOTALS = {
    "sonar.step": {"count": 30, "device_ms": 9600.0},
    "sonar.guidance": {"count": 30, "device_ms": 9570.6},
    "sonar.model": {"count": 60, "device_ms": 9570.0},
    "sonar.attention": {"count": 960, "device_ms": 7800.0},
    "sonar.noise": {"count": 30, "device_ms": 0.21},
}
RUN = {"trace": {"ops": []}}


def _totals(monkeypatch, totals):
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)


def test_portbench_span_reader(monkeypatch):
    _totals(monkeypatch, TOTALS)
    assert attention_ms.read(RUN) == pytest.approx(130.0)  # 7,800 ms over 60 calls


def test_portbench_span_reader_unguided(monkeypatch):
    _totals(monkeypatch, {k: v for k, v in TOTALS.items() if k != "sonar.guidance"})
    assert attention_ms.read(RUN) == pytest.approx(130.0)


@pytest.mark.parametrize("case", ["no trace", "no spans", "no attention", "no span_totals"])
def test_portbench_span_reader_finds_nothing(monkeypatch, case):
    run = RUN
    if case == "no trace":
        _totals(monkeypatch, TOTALS)
        run = {"trace": None}
    elif case == "no spans":
        _totals(monkeypatch, {})
    elif case == "no attention":
        _totals(monkeypatch, {k: v for k, v in TOTALS.items() if k != "sonar.attention"})
    else:  # a program that records no spans of its own
        monkeypatch.delattr(profiling, "span_totals")
    assert attention_ms.read(run) is None
