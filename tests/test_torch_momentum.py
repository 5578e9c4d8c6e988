"""The port's momentum state machine, ancestral split and guidance against
the JAX package, on the same numpy inputs over several steps (so the
history's has=False → True transition and the step windows are crossed).
Tolerance: 1e-6 absolute, scaled by the magnitude where it exceeds 1 —
elementwise code."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.samplers.ancestral as ja
import sonar_tpu.samplers.guidance as jg
import sonar_tpu.samplers.momentum as jm
import sonar_tpu_torch.samplers.ancestral as ta
import sonar_tpu_torch.samplers.guidance as tg
import sonar_tpu_torch.samplers.momentum as tm

ATOL = 1e-6
SIGMAS = [(9.0, 6.0), (6.0, 3.5), (3.5, 1.5), (1.5, 0.4)]


def _close(a, b, atol=ATOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= atol * scale, float(np.abs(a - b).max())


def _cfgs(**kw):
    jkw = dict(kw)
    if "guidance" in kw and kw["guidance"] is not None:
        g = kw["guidance"]
        jkw["guidance"] = jm.GuidanceConfig(**{**g, "latent": jnp.asarray(g["latent"])})
        kw["guidance"] = tm.GuidanceConfig(**{**g, "latent": torch.from_numpy(g["latent"])})
    return jm.SonarConfig(**jkw), tm.SonarConfig(**kw)


def _run_both(jcfg, tcfg, *, shape=(1, 4, 8, 8), steps=SIGMAS, rand_init=None):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 5
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js, ts = jm.init_momentum_state(jx), tm.init_momentum_state(tx)
    jri = None if rand_init is None else jnp.asarray(rand_init)
    tri = None if rand_init is None else torch.from_numpy(rand_init)
    for step, (sigma, sigma_down) in enumerate(steps):
        den = (rng.standard_normal(shape) * 0.5 + x * 0.8).astype(np.float32)
        jx, js = jm.momentum_step(jcfg, js, jx, jnp.asarray(den), jnp.float32(sigma),
                                  jnp.float32(sigma_down), step=step, rand_init=jri)
        tx, ts = tm.momentum_step(tcfg, ts, tx, torch.from_numpy(den), sigma, sigma_down,
                                  step=step, rand_init=tri)
        _close(tx.numpy(), jx)
        _close(ts["hd"].numpy(), js["hd"])
        assert ts["has"] == bool(js["has"]), step
        x = np.asarray(jx)


@pytest.mark.parametrize("mode", ["new", "classic", "denoised"])
@pytest.mark.parametrize("init", ["zero", "sample", "sample_norm", "rand"])
def test_momentum_step_modes_and_inits(mode, init):
    jcfg, tcfg = _cfgs(momentum_mode=mode, init=init, momentum=0.8, momentum_hist=0.6,
                       direction=-0.5)
    ri = np.random.default_rng(9).standard_normal((1, 4, 8, 8)).astype(np.float32)
    _run_both(jcfg, tcfg, rand_init=ri if init == "rand" else None)


@pytest.mark.parametrize("window", [
    dict(momentum_start_step=1, momentum_end_step=2),
    dict(momentum_start_step=2, momentum_end_step=9999, always_update_history=False),
    dict(momentum_start_step=0, momentum_end_step=0, always_update_history=False),
])
@pytest.mark.parametrize("init", ["zero", "sample"])
def test_momentum_step_windows(window, init):
    _run_both(*_cfgs(init=init, **window))


@pytest.mark.parametrize("blend", ["inject", "subtract_b", "multiply", "maximum", "slerp"])
def test_momentum_step_blend_modes(blend):
    _run_both(*_cfgs(blend_mode=blend, momentum=0.7))
    _run_both(*_cfgs(momentum_blend_mode=blend, history_blend_mode="difference",
                     momentum_mode="classic"))


@pytest.mark.parametrize("momentum,hist", [(1.0, 0.75), (0.9, 1.0)])
def test_momentum_early_outs(momentum, hist):
    _run_both(*_cfgs(momentum=momentum, momentum_hist=hist))


def test_config_surface_matches():
    jcfg, tcfg = _cfgs(direction=-0.3, momentum_hist=0.4)
    assert tcfg.history_ratios == pytest.approx(jcfg.history_ratios)
    assert tm.SonarConfig().updated({"momentum": 0.5}).momentum == 0.5
    assert [f.name for f in dataclasses.fields(tm.SonarConfig)] == \
        [f.name for f in dataclasses.fields(jm.SonarConfig)]
    with pytest.raises(ValueError, match="must be one of"):
        tm.SonarConfig(init="bogus")
    for step in range(4):
        c = tm.SonarConfig(momentum_start_step=1, momentum_end_step=2)
        jc = jm.SonarConfig(momentum_start_step=1, momentum_end_step=2)
        assert tm.check_step(c, step) == bool(jm.check_step(jc, step))


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_ancestral_steps_match_jax(eta):
    s = np.asarray([14.6, 7.0, 2.0, 0.5, 0.03, 0.0], np.float32)
    for fn_t, fn_j in ((ta.get_ancestral_step, ja.get_ancestral_step),
                       (ta.get_ancestral_step_rf, ja.get_ancestral_step_rf)):
        sj = s / 15.0 if fn_j is ja.get_ancestral_step_rf else s
        out = fn_t(torch.from_numpy(sj[:-1]), torch.from_numpy(sj[1:]), eta)
        ref = fn_j(jnp.asarray(sj[:-1]), jnp.asarray(sj[1:]), eta)
        for o, r in zip(out, ref):
            _close(torch.broadcast_to(o, (5,)).numpy(), jnp.broadcast_to(r, (5,)))
    x, den = np.float32([[1.0, 2.0]]), np.float32([[0.5, -1.0]])
    _close(ta.to_d(torch.from_numpy(x), 2.0, torch.from_numpy(den)).numpy(),
           ja.to_d(jnp.asarray(x), 2.0, jnp.asarray(den)))


@pytest.mark.parametrize("gtype", ["linear", "euler"])
@pytest.mark.parametrize("sig", [(5.0, 3.0), (3.0, 3.0)])
def test_guidance_step_matches_jax(gtype, sig):
    rng = np.random.default_rng(4)
    latent, x, den = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(3))
    g = dict(guidance_type=gtype, factor=0.3, start_step=1, end_step=3, latent=latent)
    jcfg, tcfg = _cfgs(guidance=g, guidance_blend_mode="inject")
    jref = jg.prepare_ref_latent(jcfg.guidance.latent)
    tref = tg.prepare_ref_latent(tcfg.guidance.latent)
    _close(tref.numpy(), jref)
    for step in range(5):
        out = tg.guidance_step(tcfg, step, torch.from_numpy(x), torch.from_numpy(den),
                               *sig, tref)
        ref = jg.guidance_step(jcfg, step, jnp.asarray(x), jnp.asarray(den),
                               *(jnp.float32(v) for v in sig), jref)
        _close(out.numpy(), ref)


def test_prepare_ref_latent_zero_std_guard():
    z = np.zeros((1, 2, 4, 4), np.float32)
    assert np.isfinite(tg.prepare_ref_latent(torch.from_numpy(z)).numpy()).all()
    _close(tg.prepare_ref_latent(torch.from_numpy(z)).numpy(),
           jg.prepare_ref_latent(jnp.asarray(z)))
