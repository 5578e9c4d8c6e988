"""Wavelet CFG, the model-sampling protocol and the sigma schedules of the
port against the JAX package's, on the CPU.

``WaveletCFG`` on the same cond/uncond/x arrays: ``atol=5e-5·scale,
rtol=2e-5`` (scale the JAX output's largest magnitude), the tolerance of
tests/test_reference_wcfg_oracle.py. The port picks the rule and computes
the percentages on the host in float32; the JAX package traces them. The
percentages and scheduled scales themselves: 1e-6 absolute (float32 host
arithmetic against XLA's float32; cos/sin/log/exp may differ by an ulp).
Model sampling and schedules: 1e-6 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.cfg as jc
import sonar_tpu.samplers.schedules as js
import sonar_tpu_torch.cfg as tc
import sonar_tpu_torch.samplers.schedules as ts
from sonar_tpu.utils.profiling import set_verbose_sink as j_sink
from sonar_tpu_torch.utils.misc import step_from_sigmas, step_from_sigmas_f32
from sonar_tpu_torch.utils.profiling import set_verbose_sink as t_sink

SHAPE = (1, 4, 32, 32)
SIGMAS = np.asarray([14.6, 9.0, 5.0, 2.0, 1.0, 0.5, 0.1, 0.03, 0.0], np.float32)
CONFIG3 = dict(wave="db4", level=3, padding_mode="periodization", high_precision_mode=False,
               diff=dict(yl_scale=8.0, yh_scales=[7.0, [6.0, 6.0, 7.0], "fill"],
                         scales_end=dict(yl_scale=6.0, yh_scales=6.0),
                         schedule="half_cosine", schedule_mode="sampling"))  # bench.py:472-477
SCHEDULES = ("linear", "logarithmic", "log", "exponential", "exp", "half_cosine", "sine", "sin")
MODES = ("sampling", "model_sampling", "enabled_sampling", "enabled_model_sampling", "sigmas",
         "sigma_range", "enabled_sigmas", "enabled_sigma_range", "step", "steps",
         "enabled_steps")


def _arrays(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    c, u = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return x, c, u


def _wcfg_pair(rules_kw, sigma, *, shape=SHAPE, sample_sigmas=SIGMAS, x64=False, seed=0):
    """(port, jax) outputs of one WaveletCFG call on the same arrays."""
    x, c, u = _arrays(shape, seed)
    s = np.full((shape[0],), sigma, np.float32)
    base = dict(input=x, sigma=s, cond=x - c, uncond=x - u, cond_denoised=c,
                uncond_denoised=u)
    extra = dict(cond_scale=7.0, sample_sigmas=sample_sigmas)
    jw = jc.WaveletCFG(rules=jc.WCFGRules.build(**rules_kw))
    if x64:
        with jax.enable_x64(True):
            want = np.asarray(jax.jit(lambda d: jw({**d, **extra, "model_sampling":
                                                    jc.DiscreteSampling()}))(
                {k: jnp.asarray(v) for k, v in base.items()}))
    else:
        want = np.asarray(jax.jit(lambda d: jw({**d, **extra,
                                                "model_sampling": jc.DiscreteSampling()}))(
            {k: jnp.asarray(v) for k, v in base.items()}))
    tw = tc.WaveletCFG(rules=tc.WCFGRules.build(**rules_kw))
    got = tw({**{k: torch.from_numpy(v) for k, v in base.items()}, **extra,
              "model_sampling": tc.DiscreteSampling(), "sigma_host": float(s.max())})
    return got.numpy(), want


def _close_wcfg(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-5 * scale, rtol=2e-5)


@pytest.mark.parametrize("window,sigma", [
    ({}, 14.6), ({}, 5.0), ({}, 0.03), ({}, 0.0),
    ({"start_sigma": 9.0, "end_sigma": 1.0}, 9.0),   # on the window's edges
    ({"start_sigma": 9.0, "end_sigma": 1.0}, 1.0),
    ({"start_sigma": 9.0, "end_sigma": 1.0}, 12.0),  # outside: the fallback branch
    ({"start_sigma": 9.0, "end_sigma": 1.0}, 0.5),
])
def test_config3_rules_match_jax(window, sigma):
    got, want = _wcfg_pair({**CONFIG3, **window}, sigma)
    _close_wcfg(got, want)


def _pcts(mod, rule_window, sigma, sigmas):
    return mod.WCFGPercentages.build(ms=mod.DiscreteSampling(), sigma=sigma, sigmas=sigmas,
                                     **rule_window)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_every_schedule_and_mode_matches_jax(schedule, mode):
    kw = dict(schedule=schedule, schedule_mode=mode, schedule_offset=0.05,
              schedule_multiplier=0.9, schedule_offset_after=0.02, schedule_max=0.97)
    window = dict(start_sigma=9.0, end_sigma=0.5)
    for sigma in (9.0, 4.0, 1.3, 0.5):
        for reverse in (False, True):
            sk = dict(kw, reverse_schedule=reverse, reverse_schedule_after=not reverse)
            want = float(jc.WCFGScheduledScale.build(**sk).get_b_scale(
                _pcts(jc, window, jnp.float32(sigma), SIGMAS)))
            got = float(tc.WCFGScheduledScale.build(**sk).get_b_scale(
                _pcts(tc, window, sigma, SIGMAS)))
            assert abs(got - want) <= 1e-6, (sigma, reverse, got, want)


@pytest.mark.parametrize("mode", ["sampling", "enabled_sampling", "sigmas", "enabled_sigmas",
                                  "steps", "enabled_steps"])
def test_each_mode_family_through_wcfg_matches_jax(mode):
    rules = {**CONFIG3, "start_sigma": 9.0, "end_sigma": 0.5,
             "diff": dict(CONFIG3["diff"], schedule_mode=mode)}
    got, want = _wcfg_pair(rules, 1.3)
    _close_wcfg(got, want)


def test_steps_mode_on_sigmas_equal_at_4_decimals():
    """Two table sigmas that round equal at 4 decimals: the traced step
    helper's arithmetic (step_diff 0, no 2-decimal rounding)."""
    sig = np.asarray([14.6, 5.00001, 5.00004, 1.23456, 0.5, 0.0], np.float32)
    for sigma in (5.00003, 5.00001, 3.1, 1.23456, 0.77):
        for mode in ("steps", "enabled_steps"):
            want = float(_pcts(jc, {"start_sigma": 10.0, "end_sigma": 0.5}, jnp.float32(sigma),
                               sig).pct_from_schedmode(mode))
            got = float(_pcts(tc, {"start_sigma": 10.0, "end_sigma": 0.5}, sigma,
                              sig).pct_from_schedmode(mode))
            assert abs(got - want) <= 1e-6, (sigma, mode, got, want)
    rules = {**CONFIG3, "diff": dict(CONFIG3["diff"], schedule_mode="steps")}
    got, want = _wcfg_pair(rules, 5.00003, sample_sigmas=sig)
    _close_wcfg(got, want)


def test_step_helpers():
    from sonar_tpu.utils.misc import step_from_sigmas as j_host
    from sonar_tpu.utils.misc import step_from_sigmas_traced as j_traced

    sig = np.asarray([14.6, 7.3, 3.2, 3.2, 1.1, 0.03, 0.0], np.float32)
    for s in (14.6, 10.0, 3.2, 2.0, 0.03, 0.01, 20.0, 1.1):
        step, valid = j_traced(jnp.float32(s), jnp.asarray(sig))
        got = step_from_sigmas_f32(s, sig)
        assert (got is None) == (not bool(valid))
        if got is not None:
            assert got == float(step)
        assert step_from_sigmas(s, sig) == j_host(s, sig)
    assert step_from_sigmas_f32(1.0, np.asarray([2.0, 0.0, 1.0, 0.0], np.float32)) is None


@pytest.mark.parametrize("target", ["denoised", "noise", "noise_norm"])
def test_target_modes_match_jax(target):
    rules = {**CONFIG3, "target_mode": target, "blend_strength": 0.7,
             "cond": dict(yl_scale=1.1, yh_scales=0.9), "final": dict(yh_scales=[1.2, 1.0])}
    got, want = _wcfg_pair(rules, 2.0)
    _close_wcfg(got, want)


def test_several_rules_first_match_wins():
    first = {"start_sigma": 6.0, "end_sigma": 1.0, "diff": dict(yl_scale=3.0)}
    rules = {**CONFIG3, "start_sigma": 10.0, "end_sigma": 2.0,
             "rules": [first, {"start_sigma": 20.0, "end_sigma": 0.0,
                               "difference_blend_mode": "lerp",
                               "blend_strength": {"value_start": 0.2, "value_end": 0.9,
                                                  "schedule": "sine"}}]}
    assert tc.WCFGRules.build(**rules).match_index(4.0) == 0
    assert tc.WCFGRules.build(**rules).match_index(1.5) == 1
    assert tc.WCFGRules.build(**rules).match_index(14.0) == 2
    assert tc.WCFGRules.build(**rules).match_index(25.0) == 3
    for sigma in (4.0, 1.5, 14.0):
        got, want = _wcfg_pair(rules, sigma)
        _close_wcfg(got, want)


@pytest.mark.parametrize("high", [False, True])
def test_high_precision_mode_matches_jax(high):
    """True: float64 in both (the JAX package under ``jax.enable_x64(True)``, a context:
    other files share the worker); False: float32 in both."""
    rules = {**CONFIG3, "high_precision_mode": high, "padding_mode": "symmetric",
             "blend_strength": 0.8}
    got, want = _wcfg_pair(rules, 3.0, x64=high)
    _close_wcfg(got, want)
    if high:  # both round one float64 result to float32: within two float32 ulps
        np.testing.assert_allclose(got, want, atol=2.0**-22 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("shape,one_d", [((1, 4, 96), True), ((1, 2, 3, 16, 16), True),
                                         ((1, 2, 3, 16, 16), False)])
def test_3d_and_5d_latents_match_jax(shape, one_d):
    rules = {**CONFIG3, "use_1d_dwt": one_d, "diff": dict(yl_scale=4.0, yh_scales=[3.0, 2.0])}
    got, want = _wcfg_pair(rules, 2.0, shape=shape)
    assert got.shape == shape
    _close_wcfg(got, want)


def test_3d_latent_needs_1d_dwt():
    x = torch.zeros(1, 4, 32)
    args = dict(input=x, sigma=torch.ones(1), cond=x, uncond=x, cond_denoised=x,
                uncond_denoised=x, cond_scale=1.0)
    with pytest.raises(RuntimeError, match="use_1d_dwt"):
        tc.WaveletCFG(rules=tc.WCFGRules.build(**CONFIG3))(args)


def _verbose_lines(mod, sink, rules_kw, sigma, lib):
    msgs = []
    sink(msgs.append)
    try:
        if lib == "jax":
            jax.block_until_ready(_wcfg_pair(rules_kw, sigma)[1])
        else:
            _wcfg_pair(rules_kw, sigma)
    finally:
        sink(print)
    return msgs


@pytest.mark.parametrize("rules_kw", [
    {**CONFIG3, "verbose": True, "diff": {"yl_scale": 1.25, "yh_scales": [0.9, 1.1]},
     "cond": {"yl_scale": 1.5}},
    {**CONFIG3, "verbose": True, "start_sigma": 9.0, "end_sigma": 1.0,
     "diff": dict(CONFIG3["diff"], schedule="linear", schedule_mode="enabled_sigmas"),
     "uncond": {"yl_scale": 0.5, "yh_scales": 2.0},
     "blend_strength": {"value_start": 0.5, "value_end": 1.0, "schedule": "linear"}},
])
def test_verbose_dump_is_the_jax_packages_line_for_line(rules_kw):
    """The JAX package's dump rides jax.debug.callback; the port writes the
    same lines through its verbose_writer (percentages to 4 decimals, the
    scales as their float32 values)."""
    msgs = []
    j_sink(msgs.append)
    t_msgs = []
    t_sink(t_msgs.append)
    try:
        _wcfg_pair(rules_kw, 5.0)
        jax.effects_barrier()
    finally:
        j_sink(print)
        t_sink(print)
    assert msgs and len(t_msgs) == len(msgs)
    assert t_msgs == msgs


# ---------------------------------------------------------------------------
# model sampling and schedules
# ---------------------------------------------------------------------------

PROBES = [0.0, 1e-12, 0.0291675, 0.03, 0.2, 1.0, 2.5, 14.6, 30.0, 200.0]


@pytest.mark.parametrize("name", ["DiscreteSampling", "ContinuousEDM", "Flow"])
def test_model_sampling_matches_jax(name):
    jm, tm = getattr(jc, name)(), getattr(tc, name)()
    probes = [p / 100 for p in PROBES] if name == "Flow" else PROBES
    assert tm.sigma_min == jm.sigma_min and tm.sigma_max == jm.sigma_max
    want = np.asarray(jm.timestep(jnp.asarray(probes, jnp.float32)))
    np.testing.assert_allclose(tm.timestep(np.asarray(probes, np.float32)), want, rtol=1e-6)
    np.testing.assert_allclose(tm.timestep(torch.tensor(probes)).numpy(), want, rtol=1e-6)
    for s in probes:
        np.testing.assert_allclose(float(tm.timestep(s)), float(jm.timestep(s)), rtol=1e-6)
    for pct in (-0.1, 0.0, 0.13, 0.5, 0.999, 1.0):
        assert tm.percent_to_sigma(pct) == pytest.approx(jm.percent_to_sigma(pct), rel=1e-6)
    for s0 in (jm.sigma_max, jm.sigma_max * (1 - 5e-6), jm.sigma_max * 0.98, 1e3):
        assert tc.max_denoise(tm, s0) == jc.model_sampling.max_denoise(jm, s0)


def test_flow_shift_and_tables():
    from sonar_tpu.cfg.model_sampling import time_snr_shift as j_shift

    jm, tm = jc.Flow(shift=3.0), tc.Flow(shift=3.0)
    np.testing.assert_array_equal(tm.sigmas, jm.sigmas)
    t = np.linspace(0, 1000, 7, dtype=np.float32)
    np.testing.assert_allclose(tm.sigma(t), np.asarray(jm.sigma(jnp.asarray(t))), rtol=1e-6)
    np.testing.assert_allclose(tm.sigma(torch.from_numpy(t)).numpy(),
                               np.asarray(jm.sigma(jnp.asarray(t))), rtol=1e-6)
    assert tc.time_snr_shift(2.0, 0.3) == j_shift(2.0, 0.3)
    np.testing.assert_array_equal(tc.make_beta_sigmas(), jc.make_beta_sigmas())


@pytest.mark.parametrize("name", sorted(js.SCHEDULERS))
@pytest.mark.parametrize("denoise", [1.0, 0.6])
def test_schedules_match_jax(name, denoise):
    for ms_j, ms_t in ((jc.DiscreteSampling(), tc.DiscreteSampling()),
                       (jc.ContinuousEDM(), tc.ContinuousEDM())):
        want = np.asarray(js.get_sigmas(name, 12, ms_j, denoise=denoise))
        got = ts.get_sigmas(name, 12, ms_t, denoise=denoise)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert ts.get_sigmas(name, 5, denoise=0.0).numel() == 0
    with pytest.raises(ValueError):
        ts.get_sigmas("nope", 5)


def test_schedule_interp_matches_jax():
    for name in SCHEDULES:
        for v in (-0.5, 0.0, 1e-6, 0.25, 0.5, 0.9, 1.0, 1.5):
            want = float(jc.schedule_interp(name, jnp.float32(v)))
            assert abs(float(tc.schedule_interp(name, v)) - want) <= 1e-6, (name, v)
    with pytest.raises(ValueError):
        tc.schedule_interp("bogus", 0.5)
    assert math.isinf(tc.WCFGRule.build().start_sigma)


def test_blend_and_misc_helpers_match_jax():
    import importlib

    jb, jm, tb, tm = (importlib.import_module(m) for m in (
        "sonar_tpu.core.blend", "sonar_tpu.utils.misc", "sonar_tpu_torch.core.blend",
        "sonar_tpu_torch.utils.misc"))

    assert sorted(tb.BLENDING_MODES) == sorted(jb.BLENDING_MODES)
    for name in sorted(jb.BLENDING_MODES):
        for a, b, t in ((0.3, 1.7, 0.25), (2.0, -1.0, 0.9)):
            want = jb.blend_scalar(a, b, t, blend_function=jb.BLENDING_MODES[name],
                                   clamp_function=lambda v: jm.clamp_float(v, -1.0, 1.5))
            got = tb.blend_scalar(a, b, t, blend_function=tb.BLENDING_MODES[name],
                                  clamp_function=lambda v: tm.clamp_float(v, -1.0, 1.5))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7), name
    assert tb.blend_scalar(1.0, 3.0, 0.25) == jb.blend_scalar(1.0, 3.0, 0.25) == 1.5
    tb.register_blend_mode("half_sum", lambda a, b, t: (a + b) * 0.5)
    try:
        assert float(tb.blend("half_sum")(torch.tensor(1.0), torch.tensor(3.0), 0.0)) == 2.0
    finally:
        del tb.BLENDING_MODES["half_sum"]
    d = {"a": 1, "b": {"a": 2, "c": 3}, "c": 4}
    assert tm.filter_dict(d, ("a", "b")) == jm.filter_dict(d, ("a", "b"))
    assert tm.filter_dict(d, ("a", "b"), recursive=True) == jm.filter_dict(
        d, ("a", "b"), recursive=True)
    assert tm.clamp_float(7.0) == jm.clamp_float(7.0) == 1.0
