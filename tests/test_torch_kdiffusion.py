"""The k-diffusion samplers of the port (``sonar_tpu_torch.samplers.kdiffusion``)
against the JAX package on the CPU, and the registry's 31 names.

The two packages draw from different streams, so trajectories are held equal
on one injected numpy noise stream ``noise_sampler(step, sigma, sigma_next)``
(two draws a step, 2i and 2i+1, for dpmpp_sde), with a float32 stub denoiser,
and for euler, dpmpp_2m and dpmpp_2s_ancestral also with a narrow UNet whose
weights are carried across by the converter. Tolerance: 1e-4 relative to the
trajectory's largest magnitude in float32 (host float32 scalars against
XLA's, convolutions and chains of steps rounding in another order).
bfloat16 latents (euler, dpmpp_2s_ancestral, dpmpp_2m): two bfloat16 ulps
(2 * 2^-7) of the trajectory's largest magnitude; both packages step in
float32 and round the carry to bfloat16 once a step, and a float32
difference can flip one such rounding.

The port decides on the host what the JAX program selects elementwise: it
skips the model calls whose results JAX throws away (counted below), and
draws noise exactly where the JAX program draws it.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api.functions as japi_f
import sonar_tpu.models.unet as ju
import sonar_tpu.samplers as JS
import sonar_tpu.samplers.kdiffusion as JK
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.api.functions as tapi_f
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.samplers as TS
import sonar_tpu_torch.samplers.kdiffusion as TK
from sonar_tpu.api.pipeline import SonarPipeline as JPipeline
from sonar_tpu.cfg.model_sampling import Flow as JFlow
from sonar_tpu_torch.cfg import Flow as TFlow
from sonar_tpu_torch.core.rng import derive_seed, seed_from
from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler

REL = 1e-4
BF16_REL = 2 * 2.0**-7
SHAPE = (1, 4, 8, 8)
STEPS = 8
UNET_KW = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,),
               num_heads=2, norm_groups=4)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _sigmas(steps=STEPS, tail=True):
    """bench.py's Karras-style schedule 14.6 → 0.03, with or without a final 0."""
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return (np.concatenate([s, [0.0]]) if tail else s).astype(np.float32)


def _stub(lib, shape=SHAPE):
    """A float32 denoiser whatever the latent's type."""
    target = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) / 100.0
    if lib == "jax":
        t = jnp.asarray(target)
        return lambda x, s, **_: ((x.astype(jnp.float32) * 0.9 + t)
                                  / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05))
    t = torch.from_numpy(target)
    return lambda x, s, **_: (x.float() * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)


def _draws(n, shape=SHAPE, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _streams(noises, record=None):
    stacked = jnp.asarray(np.stack(noises))

    def tns(i, s, sn):
        if record is not None:
            record.append(i)
        return torch.from_numpy(noises[i])

    return (lambda i, s, sn: stacked[i]), tns


def _unets():
    jcfg = ju.UNetConfig(**UNET_KW)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    return ju.make_denoiser(params, jcfg), tu.make_denoiser(model.eval())


def _x0(sig, dtype="f32"):
    x0 = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * sig[0]
    if dtype == "bf16":
        return jnp.asarray(x0).astype(jnp.bfloat16), torch.from_numpy(x0).bfloat16()
    return jnp.asarray(x0), torch.from_numpy(x0)


def _run_both(name, kw, *, steps=STEPS, tail=True, dtype="f32", models=None, record=None):
    sig = _sigmas(steps, tail)
    jx, tx = _x0(sig, dtype)
    jns, tns = _streams(_draws(2 * (len(sig) - 1)), record)
    jm, tm = models or (_stub("jax"), _stub("torch"))
    # eta > 1 pushes sigma_up to sigma_next: the JAX package's compiled scan
    # contracts sigma_next^2 - sigma_up^2 into a fused multiply-add and takes
    # the root of a rounding residue (NaN or ~1e-3 where the reference's
    # sigma_down is 0); its eager loop (method="python") computes 0, as the
    # port and the reference do
    jkw = dict(kw, method="python") if kw.get("eta", 0) > 1 else kw
    if name == "dpmpp_2m":  # takes no noise
        ref = JK.KDIFFUSION_SAMPLERS[name](jm, jx, jnp.asarray(sig), **jkw)
        out = TK.KDIFFUSION_SAMPLERS[name](tm, tx, torch.from_numpy(sig), **kw)
    else:
        ref = JK.KDIFFUSION_SAMPLERS[name](jm, jx, jnp.asarray(sig), noise_sampler=jns, **jkw)
        out = TK.KDIFFUSION_SAMPLERS[name](tm, tx, torch.from_numpy(sig), noise_sampler=tns,
                                           **kw)
    return out, ref


CASES = [
    ("euler", {}), ("euler", dict(s_churn=0.8)),
    ("euler", dict(s_churn=0.7, s_tmin=0.5, s_tmax=5.0, s_noise=1.1)),
    ("euler_ancestral", {}), ("euler_ancestral", dict(eta=0.5, s_noise=0.9)),
    ("heun", {}), ("heun", dict(s_churn=0.5, s_tmin=0.5, s_tmax=5.0)),
    ("heunpp2", {}), ("heunpp2", dict(s_churn=0.6)),
    ("dpm_2", {}), ("dpm_2", dict(s_churn=0.5, s_tmin=0.5, s_tmax=5.0)),
    ("dpm_2_ancestral", {}), ("dpm_2_ancestral", dict(eta=0.6)),
    ("dpm_2_ancestral", dict(eta=1.1)),
    ("dpmpp_2m", {}),
    ("dpmpp_2s_ancestral", {}), ("dpmpp_2s_ancestral", dict(eta=0.5, s_noise=0.8)),
    ("dpmpp_2s_ancestral", dict(eta=1.1)),
    ("dpmpp_sde", {}), ("dpmpp_sde", dict(r=0.4, eta=0.8)),
    ("dpmpp_2m_sde", {}), ("dpmpp_2m_sde", dict(solver_type="heun")),
    ("dpmpp_2m_sde", dict(eta=0.0)), ("dpmpp_2m_sde", dict(eta=0.5, s_noise=0.8)),
    ("dpmpp_3m_sde", {}), ("dpmpp_3m_sde", dict(eta=0.0)), ("dpmpp_3m_sde", dict(eta=0.5)),
    ("ddim", {}), ("ddim", dict(eta=0.7)),
    ("ddpm", {}), ("ddpm", dict(s_noise=0.7)),
    ("lcm", {}), ("lcm", dict(ancestral_mode="rf")),
    ("res_multistep", {}), ("res_multistep_ancestral", {}),
    ("res_multistep_ancestral", dict(eta=0.5)),
]


# schedules that end at 0.03, not 0: no tail step, and heunpp2's last stages
# land on 0.03
NO_TAIL = ["euler_ancestral", "heun", "heunpp2", "dpm_2", "dpm_2_ancestral", "dpmpp_2m",
           "dpmpp_2s_ancestral", "dpmpp_2m_sde", "dpmpp_3m_sde", "ddpm", "lcm",
           "res_multistep_ancestral"]


@pytest.mark.parametrize("name,kw,tail", [(n, kw, True) for n, kw in CASES]
                         + [(n, {}, False) for n in NO_TAIL],
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in CASES] + [f"{n}-no_tail" for n in NO_TAIL])
def test_sampler_matches_jax(name, kw, tail):
    out, ref = _run_both(name, kw, tail=tail)
    assert out.dtype == torch.float32 and out.shape == SHAPE
    assert bool(torch.isfinite(out).all())
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("name", ["dpmpp_sde_gpu", "dpmpp_2m_sde_gpu", "dpmpp_3m_sde_gpu"])
def test_gpu_alias_matches_jax(name):
    """ComfyUI's _gpu names, run through both registries by name."""
    out, ref = _run_both(name, {})
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("name", ["euler", "dpmpp_2m", "dpmpp_2s_ancestral"])
def test_unet_slice_matches_jax(name):
    """The slice as a whole: a narrow UNet through make_denoiser, four steps
    and the tail."""
    out, ref = _run_both(name, {}, steps=4, models=_unets())
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("name", ["euler", "dpmpp_2s_ancestral", "dpmpp_2m"])
def test_bf16_latent_matches_jax(name):
    out, ref = _run_both(name, {}, dtype="bf16")
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close_rel(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rel=BF16_REL)


def test_registry_has_the_jax_packages_31_names():
    assert sorted(tapi_f.SAMPLERS) == sorted(japi_f.SAMPLERS) and len(tapi_f.SAMPLERS) == 31
    assert sorted(TS.SAMPLERS) == sorted(JS.SAMPLERS)
    assert sorted(TS.__all__) == sorted(JS.__all__)
    assert not hasattr(tapi_f, "NOT_PORTED")
    for name, fn in tapi_f.SAMPLERS.items():
        assert tapi.get_sampler(name) is fn is TS.SAMPLERS[name]
        assert fn.__name__ == japi_f.get_sampler(name).__name__
    for base in ("dpmpp_sde", "dpmpp_2m_sde", "dpmpp_3m_sde"):
        assert tapi.get_sampler(base + "_gpu") is tapi.get_sampler(base)
    for name in ("deis", "lms", "ipndm", "ipndm_v", "uni_pc", "uni_pc_bh2", "dpm_fast",
                 "dpm_adaptive"):
        assert tapi.get_sampler(name)._needs_host_sigmas


@pytest.mark.parametrize("name", ["dpmpp_2m", "dpmpp_3m_sde", "heunpp2"])
def test_resume_is_bitwise(name):
    """stop/resume: the carry (latent, history, noise state) continues the
    run bit for bit; the SDE one draws its default Brownian noise."""
    sig = torch.from_numpy(_sigmas())
    x0 = _x0(_sigmas())[1]
    fn, model = TS.SAMPLERS[name], _stub("torch")
    full = fn(model, x0, sig, seed=3)
    _x, carry = fn(model, x0, sig, seed=3, stop_step=4, return_state=True)
    assert torch.equal(_x, carry[0])
    resumed = fn(model, x0, sig, seed=3, resume_from=carry, start_step=4)
    assert torch.equal(resumed, full)


def test_lcm_rf_through_the_pipeline_with_flow():
    """SonarPipeline with Flow model sampling hands lcm ``ancestral_mode="rf"``;
    an SDE sampler without the knob warns, as in the JAX package."""
    sig = np.linspace(0.95, 0.0, STEPS + 1).astype(np.float32)
    jns, tns = _streams(_draws(STEPS))
    jx, tx = _x0(np.asarray([1.0], np.float32))
    ref = JPipeline(model=_stub("jax"), sampler="lcm", model_sampling=JFlow())(
        jx, sig, noise_sampler=jns)
    pipe = tapi.SonarPipeline(model=_stub("torch"), sampler="lcm", model_sampling=TFlow())
    out = pipe(tx, torch.from_numpy(sig), noise_sampler=tns)
    _close_rel(out.numpy(), ref)
    direct = TS.sample_lcm(_stub("torch"), tx, torch.from_numpy(sig), noise_sampler=tns,
                           ancestral_mode="rf")
    assert torch.equal(out, direct)
    assert not torch.equal(out, TS.sample_lcm(_stub("torch"), tx, torch.from_numpy(sig),
                                              noise_sampler=tns))
    with pytest.warns(UserWarning, match="over-noised"):
        tapi.SonarPipeline(model=_stub("torch"), sampler="dpmpp_2m_sde",
                           model_sampling=TFlow())(tx, torch.from_numpy(sig),
                                                   noise_sampler=tns)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tapi.SonarPipeline(model=_stub("torch"), sampler="restart",
                           model_sampling=TFlow())(tx, torch.from_numpy(sig))


@pytest.mark.parametrize("name", ["euler", "heun", "dpm_2", "heunpp2"])
def test_churn_window_stream_parity(name):
    """A windowed churn with a stateful stream (test_kdiffusion.py:516-562):
    out-of-window steps neither draw nor advance the stream. The seeded run
    equals the run fed the item's sequential draws at the in-window steps
    only, and the JAX sampler fed the same draws."""
    sig = _sigmas()
    s_tmin, s_tmax, seed = 0.5, 5.0, 1234
    in_win = [bool(s_tmin <= s <= s_tmax) for s in sig[:-1]]
    assert any(in_win) and not all(in_win)
    kw = dict(s_churn=0.7, s_tmin=s_tmin, s_tmax=s_tmax)
    jx, tx = _x0(sig)
    fn = TS.SAMPLERS[name]
    got = fn(_stub("torch"), tx, torch.from_numpy(sig), seed=seed, **kw)
    pos = sig[sig > 0]
    draw, state = make_noise_sampler(
        get_noise_item("gaussian"), SHAPE, device="cpu", sigma_min=float(pos.min()),
        sigma_max=float(sig.max()), seed=derive_seed(seed_from(seed), "noise"),
        normalized=True, ref_latent=tx)
    noise = [np.zeros(SHAPE, np.float32) for _ in in_win]
    for i, w in enumerate(in_win):
        if w:
            n, state = draw(state, float(sig[i]), float(sig[i + 1]))
            noise[i] = n.numpy()
    called = []
    jns, tns = _streams(noise, called)
    fed = fn(_stub("torch"), tx, torch.from_numpy(sig), noise_sampler=tns, **kw)
    assert called == [i for i, w in enumerate(in_win) if w]
    assert torch.equal(got, fed)
    ref = JK.KDIFFUSION_SAMPLERS[name](_stub("jax"), jx, jnp.asarray(sig), noise_sampler=jns,
                                       **kw)
    _close_rel(got.numpy(), ref)
    inert = fn(_stub("torch"), tx, torch.from_numpy(sig), s_churn=0.7, s_tmin=100.0,
               s_tmax=200.0, seed=seed)
    assert torch.equal(inert, fn(_stub("torch"), tx, torch.from_numpy(sig)))


def _ancestral_floor(sig, eta):
    sd, _su = TK._splits(sig, eta)
    return [bool(v > 0) for v in sd]


@pytest.mark.parametrize("name,kw,draws", [
    ("euler_ancestral", {}, "all"),
    ("dpmpp_2s_ancestral", dict(eta=1.1), "all"),
    ("lcm", {}, "all"),
    ("dpmpp_2m_sde", {}, "all"), ("dpmpp_3m_sde", {}, "all"),
    ("dpmpp_2m_sde", dict(eta=0.0), "none"), ("ddim", {}, "none"),
    ("ddim", dict(eta=0.7), "all"),
    ("dpm_2_ancestral", dict(eta=1.1), "sigma_down"),
    ("dpm_2_ancestral", {}, "sigma_down"),
    ("res_multistep_ancestral", {}, "sigma_next"), ("res_multistep", {}, "none"),
    ("ddpm", {}, "sigma_next"),
])
def test_draws_are_where_the_jax_program_draws(name, kw, draws):
    """The steps at which the noise stream is asked for a draw: every step
    where JAX draws unconditionally (the tail too), only where ``sigma_down
    > 0`` under dpm_2_ancestral's ``lax.cond``, only where ``sigma_next > 0``
    for res_multistep_ancestral and ddpm (c63c3dd's final-step gate)."""
    sig = _sigmas()
    n = len(sig) - 1
    called = []
    out, ref = _run_both(name, kw, record=called)
    want = {"all": list(range(n)), "none": [],
            "sigma_next": [i for i in range(n) if sig[i + 1] > 0],
            "sigma_down": [i for i, v in enumerate(_ancestral_floor(sig, kw.get("eta", 1.0)))
                           if v]}[draws]
    assert called == want
    if kw.get("eta") == 1.1:  # the floor is reached mid-trajectory, not only at the tail
        assert 0 < len([v for v in _ancestral_floor(sig, 1.1)[:-1] if not v]) < n - 1
    _close_rel(out.numpy(), ref)


# model calls of a run at STEPS steps and a final 0: the port's count, and the
# JAX program's (every second- and third-order stage evaluated on every step)
CALLS = {
    "euler": (STEPS, STEPS), "euler_ancestral": (STEPS, STEPS),
    "heun": (2 * STEPS - 1, 2 * STEPS), "heunpp2": (3 * STEPS - 3, 3 * STEPS),
    "dpm_2": (2 * STEPS - 1, 2 * STEPS), "dpm_2_ancestral": (2 * STEPS - 1, 2 * STEPS),
    "dpmpp_2m": (STEPS, STEPS), "dpmpp_2s_ancestral": (2 * STEPS - 1, 2 * STEPS),
    "dpmpp_sde": (2 * STEPS - 1, 2 * STEPS), "dpmpp_2m_sde": (STEPS, STEPS),
    "dpmpp_3m_sde": (STEPS, STEPS), "ddim": (STEPS, STEPS), "ddpm": (STEPS, STEPS),
    "lcm": (STEPS, STEPS), "res_multistep": (STEPS, STEPS),
    "res_multistep_ancestral": (STEPS, STEPS),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_model_calls_a_run(name):
    """The port skips the model calls whose results the JAX program throws
    away on the tail step; everything else is called as often."""
    sig = torch.from_numpy(_sigmas())
    calls = []
    stub = _stub("torch")

    def counted(x, s, **kw):
        calls.append(float(s[0]))
        return stub(x, s, **kw)

    out = TS.SAMPLERS[name](counted, _x0(_sigmas())[1], sig, seed=2)
    assert bool(torch.isfinite(out).all())
    port, jax_program = CALLS[name]
    assert len(calls) == port and port <= jax_program
    assert all(s > 0 for s in calls)


@pytest.mark.parametrize("name", ["dpmpp_2m_sde", "dpmpp_3m_sde"])
def test_sde_pair_defaults_to_brownian_noise(name):
    sig, x0 = torch.from_numpy(_sigmas()), _x0(_sigmas())[1]
    fn, stub = TS.SAMPLERS[name], _stub("torch")
    out = fn(stub, x0, sig, seed=4)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, fn(stub, x0, sig, seed=4, noise_item=get_noise_item("brownian")))
    assert not torch.equal(out, fn(stub, x0, sig, seed=4, noise_item=get_noise_item("gaussian")))


def test_override_hands_custom_noise_to_a_kdiffusion_sampler():
    """SamplerConfigOverride wraps a k-diffusion sampler with a custom noise
    item (the reference's headline use, py/nodes/misc.py:461-625)."""
    sig, x0 = torch.from_numpy(_sigmas()), _x0(_sigmas())[1]
    wrapped = tapi.sampler_config_override("dpmpp_2s_ancestral",
                                           noise_item=get_noise_item("pyramid"), eta=0.8)
    out = wrapped(_stub("torch"), x0, sig, seed=5)
    plain = TS.sample_dpmpp_2s_ancestral(_stub("torch"), x0, sig, seed=5, eta=0.8)
    assert bool(torch.isfinite(out).all()) and not torch.equal(out, plain)
    det = tapi.sampler_config_override("dpmpp_2m", noise_item=get_noise_item("pyramid"), eta=0.3)
    assert torch.equal(det(_stub("torch"), x0, sig), TS.sample_dpmpp_2m(_stub("torch"), x0, sig))


def test_dpmpp_sde_is_the_sonar_sampler_at_momentum_one():
    sig, x0 = torch.from_numpy(_sigmas()), _x0(_sigmas())[1]
    a = TS.sample_dpmpp_sde(_stub("torch"), x0, sig, seed=6, r=0.4)
    b = TS.sample_sonar_dpmpp_sde(_stub("torch"), x0, sig, seed=6, r=0.4,
                                  sonar_config=TS.SonarConfig(momentum=1.0))
    assert torch.equal(a, b)
