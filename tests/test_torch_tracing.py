"""The port's spans (``sonar_tpu_torch.utils.profiling.span``) and
``StepTimer``.

On the CPU: with no profiler recording a span site enters no
``record_function``, records no event, allocates nothing and leaves the
registry empty, and a guided run is bit-equal with spans on and off; under
``torch.profiler.profile`` a 3-step run with pair CFG records each span the
expected number of times, nested step > guidance > model > attention;
closed spans are folded into their name's totals, so the registry stays
small over many spans; ``trace()`` resets the registry.

On the card (marked ``cuda``; they skip without one and import nothing of
JAX, so the card's machine runs them with
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q``):
each span name's event time against the operations launched inside the
same ``record_function`` ranges, from the profiler's raw events, on a small
UNet and a small DiT with the host run ahead of the device: it holds their
device time, and equals the device time from the end of the work queued
before each range to the end of theirs (the gaps between the operations
included); an attention span of milliseconds reads its kernels' device
time within 2 %; the registry stays small while the device runs behind;
``StepTimer`` reads its steps from CUDA events.
"""

import contextlib
import itertools
import tracemalloc
from collections import Counter

import pytest
import torch

from sonar_tpu_torch.api.pipeline import SonarPipeline
from sonar_tpu_torch.models.dit import DiTConfig, init_dit_params, make_dit_denoiser
from sonar_tpu_torch.models.unet import UNetConfig, init_unet_params, make_denoiser
from sonar_tpu_torch.utils import profiling

SIGMAS = torch.tensor([14.6, 3.0, 0.7, 0.0])
SPANS = ("sonar.step", "sonar.guidance", "sonar.model", "sonar.noise", "sonar.attention")
UNET = UNetConfig(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                  attention_levels=(1,), num_heads=2, norm_groups=4)


def _pipe(net, scale=0.97):
    return SonarPipeline(model=make_denoiser(net),
                         model_uncond=make_denoiser(lambda x, c, **kw: net(x * scale, c, **kw)),
                         sampler="sonar_euler_ancestral", cfg_scale=3.0)


def _attention_blocks(net) -> int:
    return sum(1 for m in net.modules() if type(m).__name__ == "Attention")


@pytest.fixture(scope="module")
def unet():
    return init_unet_params(torch.Generator().manual_seed(0), UNET, device="cpu")


@pytest.fixture()
def x0():
    return torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1)) * 14.6


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_path_enters_nothing(monkeypatch, unet, x0):
    def refuse(*a, **k):
        raise AssertionError("entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling.span("a") is profiling.span("b")
    _pipe(unet)(x0, SIGMAS, seed=3)
    assert profiling.span_totals() == {}


def _peak_bytes(ctx) -> int:
    """The most memory held at once, over its baseline, while 1,000 pairs of
    nested ``with ctx(...)`` blocks run."""
    def loop():
        for _ in itertools.repeat(None, 1000):
            with ctx("sonar.step"):
                with ctx("sonar.model"):
                    pass

    loop()
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        loop()
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


def test_off_path_allocates_nothing():
    shared = contextlib.nullcontext()
    # no more than the with statement itself takes around a shared no-op context
    assert _peak_bytes(profiling.span) <= _peak_bytes(lambda name: shared)


def test_outputs_bit_equal_with_spans_on_and_off(unet, x0):
    pipe = _pipe(unet)
    off = pipe(x0, SIGMAS, seed=3)
    on, _ = _profiled(lambda: pipe(x0, SIGMAS, seed=3))
    assert profiling.span_totals()  # the spans did record
    assert torch.equal(off, on)


def test_spans_recorded_under_the_profiler(unet, x0):
    _, prof = _profiled(lambda: _pipe(unet)(x0, SIGMAS, seed=3))
    want = {"sonar.step": 3, "sonar.guidance": 3, "sonar.model": 6, "sonar.noise": 3,
            "sonar.attention": 6 * _attention_blocks(unet)}
    assert _attention_blocks(unet) == 4
    totals = profiling.span_totals()
    assert {k: v["count"] for k, v in totals.items()} == want
    assert Counter(e.name for e in prof.events() if e.name in SPANS) == want
    for v in totals.values():
        assert set(v) == {"count", "device_ms"} and v["device_ms"] > 0
    # a guided call holds its two model calls
    assert totals["sonar.guidance"]["device_ms"] > totals["sonar.model"]["device_ms"]


def test_span_ranges_nest(unet, x0):
    _, prof = _profiled(lambda: _pipe(unet)(x0, SIGMAS, seed=3))
    ranges = {k: [] for k in SPANS}
    for e in prof.events():
        if e.name in ranges:
            ranges[e.name].append((e.time_range.start, e.time_range.end))

    def inside(r, outer):
        return [o for o in ranges[outer] if o[0] <= r[0] and r[1] <= o[1]]

    assert len(ranges["sonar.attention"]) == 24
    for att in ranges["sonar.attention"]:
        (model,) = inside(att, "sonar.model")
        (guidance,) = inside(model, "sonar.guidance")
        (step,) = inside(guidance, "sonar.step")
    for noise in ranges["sonar.noise"]:
        assert inside(noise, "sonar.step") and not inside(noise, "sonar.guidance")


def test_unguided_model_span_keeps_sigma_host(x0):
    seen = []

    def model(x, sigma, *, sigma_host):
        seen.append(sigma_host)
        return x * 0.5

    model.takes_sigma_host = True
    pipe = SonarPipeline(model=model, sampler="sonar_euler")
    _profiled(lambda: pipe(x0, SIGMAS))
    totals = profiling.span_totals()
    assert totals["sonar.model"]["count"] == 3 and "sonar.guidance" not in totals
    assert seen == pytest.approx(SIGMAS[:3].tolist())


class _FakeEvent:
    """A CUDA event stand-in on the CPU: ``record`` stamps a counter, one
    millisecond a stamp; ``query`` reads it done once ``done`` passes it."""

    clock = 0
    done = 0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def query(self):
        return self.at <= _FakeEvent.done

    def synchronize(self):
        _FakeEvent.done = max(_FakeEvent.done, self.at)

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_event_spans_fold_into_totals(monkeypatch):
    monkeypatch.setattr(_FakeEvent, "clock", 0)
    monkeypatch.setattr(_FakeEvent, "done", 0)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    n, most = 5 * profiling._FOLD_EVERY, []

    def run():
        for i in range(n):
            with profiling.span("sonar.outer"):
                with profiling.span("sonar.inner"):
                    pass
            _FakeEvent.done = _FakeEvent.clock - 8  # the device runs a little behind
            most.append(len(profiling._pending))

    _profiled(run)
    assert max(most) <= profiling._FOLD_EVERY + 8
    totals = profiling.span_totals()
    assert not profiling._pending
    # each outer span's events are four stamps apart, each inner span's one
    assert totals == {"sonar.outer": {"count": n, "device_ms": 3.0 * n},
                      "sonar.inner": {"count": n, "device_ms": 1.0 * n}}
    profiling.reset_spans()
    assert profiling.span_totals() == {}


def test_step_timer_reads_one_card_a_chain(monkeypatch):
    """A latent on a card other than the current one: no gap is read across
    the two cards' events (``elapsed_time`` would raise), and the steps
    after its first are timed."""
    monkeypatch.setattr(_FakeEvent, "clock", 0)
    monkeypatch.setattr(_FakeEvent, "done", 0)
    devices = []

    class OnCard(torch.Tensor):
        is_cuda = True
        device = torch.device("cuda", 1)

    def fake_elapsed(a, b):
        assert devices[a.at - 1] == devices[b.at - 1], "a gap read across two cards"
        return float(b.at - a.at)

    def record(ev, stream):
        _FakeEvent.clock += 1
        ev.at = _FakeEvent.clock
        devices.append(stream)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: device.index)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "record", record)
    monkeypatch.setattr(_FakeEvent, "elapsed_time", fake_elapsed)
    x = torch.Tensor._make_subclass(OnCard, torch.zeros(1))
    timer = profiling.StepTimer()
    timer.start()
    for i in range(4):
        timer({"i": i, "x": x})
    s = timer.summary()
    assert devices == [0, 1, 1, 1, 1] and s["steps"] == 3
    assert s["mean_ms"] == pytest.approx(1.0)  # one stamp a step, a millisecond each


def test_trace_resets_the_registry(tmp_path):
    def one_span(name):
        with profiling.span(name):
            torch.ones(8) + 1

    _profiled(lambda: one_span("before"))
    assert "before" in profiling.span_totals()
    with profiling.trace(str(tmp_path / "t")):
        one_span("inside")
    totals = profiling.span_totals()
    assert set(totals) == {"inside"} and totals["inside"]["count"] == 1
    assert profiling.span_totals() == totals  # reading leaves the registry as it was


# -- on the card ------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans time the card with CUDA events")
    return torch.device("cuda")


def _ranges_and_launched_ops(events, names):
    """From the profiler's raw events: each name's ``record_function`` ranges
    (host ns, in order), and the device operations as ``(launch, end)`` in ns,
    in the order of their launches."""
    cpu = torch.autograd.DeviceType.CPU
    ranges = {n: [] for n in names}
    launches, ops = {}, []
    for e in events:
        if e.device_type() == cpu:
            if e.name() in ranges:
                ranges[e.name()].append((e.start_ns(), e.end_ns()))
            elif e.name().startswith(("cuda", "cuLaunch")):
                launches[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation() and e.name() not in ranges:
            ops.append(e)
    launched = sorted((launches[e.correlation_id()], e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in ops if e.correlation_id() in launches)
    return {n: sorted(r) for n, r in ranges.items()}, launched


def _kineto_ms(launched, a, b):
    """The operations launched in ``[a, b)``: their summed device time, and
    the device time from the end of the work launched before ``a`` to the
    end of theirs (what a span's event pair measures), in ms."""
    inside = [op for op in launched if a <= op[0] < b]
    if not inside:
        return None
    before = max((op[2] for op in launched if op[0] < a), default=inside[0][1])
    return (sum(e - s for _, s, e in inside) / 1e6,
            (max(e for _, _, e in inside) - before) / 1e6)


def _spans_against_kineto(pipe, x0, sigmas):
    from torch.profiler import ProfilerActivity, profile

    def pause(info):  # the host queues the next step while the device sleeps (~0.2 s)
        if info["i"] == 0:  # the first step waits for the host: leave it out
            profiling.reset_spans()
        with torch.profiler.record_function("test.pause"):
            torch.cuda._sleep(400_000_000)

    pipe(x0, sigmas, seed=3)  # builds the kernels, picks cuDNN's algorithms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe(x0, sigmas, seed=3, callback=pause)
        torch.cuda.synchronize()
    totals = profiling.span_totals()
    ranges, launched = _ranges_and_launched_ops(prof.profiler.kineto_results.events(),
                                                SPANS + ("test.pause",))
    after_first_step = ranges["test.pause"][0][1]
    for name in SPANS:
        timed = [_kineto_ms(launched, a, b) for a, b in ranges[name] if a > after_first_step]
        assert totals[name]["count"] == len(timed) > 0, name
        assert None not in timed, name
        kernels, interval = (sum(k[i] for k in timed) for i in (0, 1))
        ms, count = totals[name]["device_ms"], len(timed)
        assert kernels <= ms * 1.02 + 0.002 * count, (name, ms, kernels)
        assert abs(ms - interval) <= 0.02 * interval + 0.005 * count, (name, ms, interval)


@pytest.mark.cuda
def test_span_event_times_match_kineto_unet(cuda):
    cfg = UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                     attention_levels=(0, 1), num_heads=4, norm_groups=8)
    net = init_unet_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    x0 = torch.randn(1, 4, 48, 48, device=cuda) * 14.6
    _spans_against_kineto(_pipe(net), x0, SIGMAS)


@pytest.mark.cuda
def test_span_event_times_match_kineto_dit(cuda):
    net = init_dit_params(torch.Generator().manual_seed(0),
                          DiTConfig(hidden=256, depth=4, num_heads=4), device=cuda)
    pipe = SonarPipeline(model_batched=make_dit_denoiser(net), sampler="sonar_euler_ancestral",
                         cfg_scale=3.0)
    x0 = torch.randn(2, 4, 64, 64, device=cuda) * 14.6
    _spans_against_kineto(pipe, x0, SIGMAS)


@pytest.mark.cuda
def test_attention_span_time_matches_its_kernels(cuda):
    from torch.profiler import ProfilerActivity, profile

    # level-0 attention over 16,384 tokens: milliseconds of kernels a span
    cfg = UNetConfig(model_channels=32, channel_mult=(1,), num_res_blocks=1,
                     attention_levels=(0,), num_heads=1, norm_groups=8)
    net = init_unet_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    den = make_denoiser(net)
    x = torch.randn(1, 4, 128, 128, device=cuda)
    sigma = torch.full((1,), 3.0, device=cuda)
    den(x, sigma)
    torch.cuda.synchronize()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000_000)  # the host queues the calls ahead of the device
        for _ in range(2):
            den(x, sigma)
        torch.cuda.synchronize()
    totals = profiling.span_totals()["sonar.attention"]
    ranges, launched = _ranges_and_launched_ops(prof.profiler.kineto_results.events(),
                                                ("sonar.attention",))
    kernels = sum(_kineto_ms(launched, a, b)[0] for a, b in ranges["sonar.attention"])
    assert totals["count"] == len(ranges["sonar.attention"]) == 2 * _attention_blocks(net)
    assert kernels > 1.0 * totals["count"]  # a millisecond or more a span
    assert kernels <= totals["device_ms"] <= 1.02 * kernels, (totals, kernels)


@pytest.mark.cuda
def test_span_registry_stays_small_on_the_card(cuda):
    x = torch.zeros(64, device=cuda)
    n = 5 * profiling._FOLD_EVERY
    most = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(n):
            with profiling.span("sonar.small"):
                x += 1
            most = max(most, len(profiling._pending))
    assert most < 2 * profiling._FOLD_EVERY, most
    assert profiling.span_totals()["sonar.small"]["count"] == n


@pytest.mark.cuda
def test_step_timer_reads_cuda_events(cuda, monkeypatch):
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral

    x = torch.zeros(1, 4, 32, 32, device=cuda)
    sample_sonar_euler_ancestral(lambda x, s, **kw: x * 0.9, x, SIGMAS, seed=0)  # warm
    torch.cuda.synchronize()

    def refuse(*a, **k):
        raise AssertionError("StepTimer synchronised inside the run")

    timer = profiling.StepTimer()
    timer.start()
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", refuse)
        sample_sonar_euler_ancestral(lambda x, s, **kw: x * 0.9, x, SIGMAS, seed=0,
                                     callback=timer)
    s = timer.summary()
    assert s["steps"] == 3 and 0 < s["p50_ms"] <= s["p90_ms"]
    assert s["steps_per_sec"] == pytest.approx(1e3 / s["mean_ms"])
