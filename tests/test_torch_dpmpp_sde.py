"""``sample_sonar_dpmpp_sde`` of the port against the JAX package, on the CPU,
and what the three samplers share: the float32 sigma batch and ``method=``.

The two packages draw from different streams, so trajectories are held equal
on one injected numpy noise stream (two draws a step, indexed 2i and 2i+1),
with a stub denoiser or a narrow UNet whose weights are carried across.
Tolerance: 1e-4 relative to the trajectory's largest magnitude in float32
(convolutions and long chains of steps round in another order in XLA and
PyTorch). bfloat16 latents: two bfloat16 ulps (2 * 2^-7) of the trajectory's
largest magnitude. Both packages run the step in float32 (the JAX package's
float32 sigmas promote it, the port widens what the step reads), hand the
second model call a float32 latent and round the carry to bfloat16 once a
step; a float32 difference can flip one such rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.models.unet as ju
import sonar_tpu.noise.base as jbase
import sonar_tpu.samplers.sonar as js
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.noise.base as tbase
import sonar_tpu_torch.samplers.sonar as ts
from sonar_tpu.samplers.momentum import GuidanceConfig as JGuidance
from sonar_tpu.samplers.momentum import SonarConfig as JCfg
from sonar_tpu_torch.noise import (PowerNoiseItem, ScheduledNoise, get_noise_item)
from sonar_tpu_torch.samplers import (sample_sonar_dpmpp_sde, sample_sonar_euler,
                                      sample_sonar_euler_ancestral)
from sonar_tpu_torch.samplers.momentum import GuidanceConfig as TGuidance
from sonar_tpu_torch.samplers.momentum import SonarConfig as TCfg

REL = 1e-4
BF16_REL = 2 * 2.0**-7
SHAPE = (1, 4, 8, 8)
UNET_KW = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,),
               num_heads=2, norm_groups=4)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _sigmas(steps, tail=True):
    """bench.py's Karras-style schedule 14.6 → 0.03, with or without a final 0."""
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return (np.concatenate([s, [0.0]]) if tail else s).astype(np.float32)


def _stub(lib, shape=SHAPE):
    """A float32 denoiser whatever the latent's type (no product is left in
    bfloat16, where XLA may keep excess precision and PyTorch rounds)."""
    target = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) / 100.0
    if lib == "jax":
        t = jnp.asarray(target)
        return lambda x, s, **_: ((x.astype(jnp.float32) * 0.9 + t)
                                  / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05))
    t = torch.from_numpy(target)
    return lambda x, s, **_: (x.float() * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)


def _stream(n_draws, shape=SHAPE, seed=5):
    rng = np.random.default_rng(seed)
    noises = [rng.standard_normal(shape).astype(np.float32) for _ in range(n_draws)]
    stacked = jnp.asarray(np.stack(noises))
    return ((lambda i, s, sn: stacked[i]),
            (lambda i, s, sn: torch.from_numpy(noises[i])))


def _unets():
    jcfg = ju.UNetConfig(**UNET_KW)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    return ju.make_denoiser(params, jcfg), tu.make_denoiser(model.eval())


class _ConstJ(jbase.NoiseItem):
    """A noise item that returns a fixed array (the ``init="rand"`` history)."""

    def __init__(self, value):
        super().__init__(1.0)
        self.value = value

    def sample(self, ctx, state, key, sigma, sigma_next, *, normalized=True):
        return jnp.asarray(self.value), state


class _ConstT(tbase.NoiseItem):
    def __init__(self, value):
        super().__init__(1.0)
        self.value = value

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        return torch.from_numpy(self.value), state


def _run_both(jcfg_kw, tcfg_kw, *, steps=8, tail=True, dtype=np.float32, models=None,
              monkeypatch=None, rand_init=None, **kw):
    sig = _sigmas(steps, tail)
    n = len(sig) - 1
    x0 = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * sig[0]
    jns, tns = _stream(2 * n)
    if rand_init is not None:
        monkeypatch.setattr(js, "get_noise_item", lambda name: _ConstJ(rand_init))
        monkeypatch.setattr(ts, "get_noise_item", lambda name: _ConstT(rand_init))
    jm, tm = models or (_stub("jax"), _stub("torch"))
    jx = jnp.asarray(x0).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x0).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    ref = js.sample_sonar_dpmpp_sde(jm, jx, jnp.asarray(sig), noise_sampler=jns,
                                    sonar_config=JCfg(**jcfg_kw), **kw)
    out = sample_sonar_dpmpp_sde(tm, tx, torch.from_numpy(sig), noise_sampler=tns,
                                 sonar_config=TCfg(**tcfg_kw), **kw)
    return out, ref


@pytest.mark.parametrize("tail", [True, False])
@pytest.mark.parametrize("kw", [
    dict(), dict(r=0.4, eta=0.8, s_noise=0.9), dict(r=0.75, eta=0.0),
    dict(r=0.25, eta=1.0, s_noise=1.1),
], ids=["default", "r.4", "eta0", "r.25"])
@pytest.mark.parametrize("momentum", [0.95, 1.0])
def test_dpmpp_sde_matches_jax(kw, momentum, tail):
    cfg = dict(momentum=momentum)
    out, ref = _run_both(cfg, cfg, tail=tail, **kw)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("cfg", [
    dict(momentum_mode="classic"), dict(momentum_mode="denoised", momentum=0.8),
    dict(init="sample"), dict(init="sample_norm", momentum_start_step=2),
    dict(blend_mode="inject", momentum_hist=0.5, direction=-0.5),
    dict(always_update_history=False, momentum_start_step=1, momentum_end_step=4),
], ids=["classic", "denoised", "sample", "sample_norm", "inject", "window"])
def test_dpmpp_sde_momentum_configs_match_jax(cfg):
    out, ref = _run_both(cfg, cfg, steps=6, eta=0.9)
    _close_rel(out.numpy(), ref)


def test_dpmpp_sde_rand_init_matches_jax(monkeypatch):
    """``init="rand"``: both sides are handed the same random history."""
    hist = np.random.default_rng(8).standard_normal(SHAPE).astype(np.float32)
    cfg = dict(init="rand", rand_init_noise_multiplier=0.7)
    out, ref = _run_both(cfg, cfg, steps=6, monkeypatch=monkeypatch, rand_init=hist)
    _close_rel(out.numpy(), ref)
    plain, _ = _run_both(dict(), dict(), steps=6)
    assert not torch.equal(out, plain)


@pytest.mark.parametrize("gtype,tail", [("linear", True), ("euler", True), ("euler", False)])
def test_dpmpp_sde_guidance_matches_jax(gtype, tail):
    latent = np.random.default_rng(9).standard_normal(SHAPE).astype(np.float32)
    g = dict(guidance_type=gtype, factor=0.1, start_step=1, end_step=4)
    out, ref = _run_both(dict(guidance=JGuidance(latent=jnp.asarray(latent), **g)),
                         dict(guidance=TGuidance(latent=torch.from_numpy(latent), **g)),
                         steps=6, tail=tail)
    _close_rel(out.numpy(), ref)
    plain, _ = _run_both(dict(), dict(), steps=6, tail=tail)
    assert not torch.equal(out, plain)


def test_dpmpp_sde_unet_slice_matches_jax():
    """The slice as a whole: a narrow UNet through make_denoiser, six steps
    and the tail, two model calls a step."""
    out, ref = _run_both(dict(), dict(), steps=6, models=_unets())
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("kw", [dict(), dict(r=0.4, eta=0.8, s_noise=0.9)],
                         ids=["default", "r.4"])
@pytest.mark.parametrize("models", ["stub", "unet"])
def test_dpmpp_sde_bf16_latent_matches_jax(models, kw):
    """One bfloat16 ulp with the float32 stub (read: bit-equal), two with the
    UNet, whose bfloat16 outputs a float32 difference can move by one."""
    out, ref = _run_both(dict(), dict(), dtype="bf16",
                         models=_unets() if models == "unet" else None, **kw)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close_rel(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
               rel=BF16_REL if models == "unet" else BF16_REL / 2)


# ---------------------------------------------------------------------------
# the sigma batch the model is conditioned on, and method=
# ---------------------------------------------------------------------------

SAMPLERS = {"euler": sample_sonar_euler, "euler_ancestral": sample_sonar_euler_ancestral,
            "dpmpp_sde": sample_sonar_dpmpp_sde}
JSAMPLERS = {"euler": js.sample_sonar_euler,
             "euler_ancestral": js.sample_sonar_euler_ancestral,
             "dpmpp_sde": js.sample_sonar_dpmpp_sde}


@pytest.mark.parametrize("name", list(SAMPLERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_model_gets_the_float32_sigma_batch_jax_sends(name, dtype):
    """Whatever the latent's type, the model is conditioned on the float32
    sigma: a bfloat16 batch would turn 14.6 into 14.625. dpmpp_sde sends the
    midpoint sigma ``s_s`` of each step too. The batches are the JAX
    sampler's, value for value (the midpoint within one float32 ulp), and
    so are the latents' types: the carry's, except that dpmpp_sde's midpoint
    call sees the float32 latent its float32 step has built."""
    sig = _sigmas(4)
    seen, jseen, types, jtypes = [], [], [], []

    def probe(x, s, **_):
        assert s.dtype == torch.float32 and s.shape == (x.shape[0],)
        seen.append(float(s[0]))
        types.append(str(x.dtype).split(".")[-1])
        return x * 0.5

    def jprobe(x, s, **_):
        assert s.dtype == jnp.float32
        jseen.append(float(s[0]))
        jtypes.append(str(x.dtype))
        return x * 0.5

    x0 = torch.zeros((2, 4, 8, 8), dtype=dtype)
    SAMPLERS[name](probe, x0, torch.from_numpy(sig), seed=1)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    jkw = {} if name == "euler" else {"noise_sampler": lambda i, s, sn: jnp.zeros((), jdt)}
    JSAMPLERS[name](jprobe, jnp.zeros((2, 4, 8, 8), jdt), jnp.asarray(sig), seed=1,
                    method="python", **jkw)
    calls = 2 * 4 - 1 if name == "dpmpp_sde" else 4  # the tail calls the model once
    assert len(seen) == calls
    assert types == jtypes[:calls] and types[0] == str(dtype).split(".")[-1]
    # the JAX loop computes both branches on the tail: its second call there is unused
    np.testing.assert_allclose(seen, jseen[:calls], rtol=2.0**-22, atol=0)
    assert seen[0] == float(sig[0]) and float(np.float32(seen[0])) == seen[0]


def test_bf16_latent_conditions_the_unet_as_jax_does():
    """A bfloat16 latent through make_denoiser on a narrow UNet: what the
    samplers hand the two denoisers at the first step (captured) is the same
    float32 sigma, and the denoised latents agree within two bfloat16 ulps
    of the largest value (the network runs in float32 on the same weights;
    its input and output are rounded to bfloat16)."""
    jden, tden = _unets()
    sig = np.float32([14.6, 9.0])
    x0 = (np.random.default_rng(2).standard_normal(SHAPE) * 14.6).astype(np.float32)
    got = {}

    def tmodel(x, s, **_):
        got["t"] = (s.clone(), tden(x, s))
        return got["t"][1]

    def jmodel(x, s, **_):
        got["j"] = (s, jden(x, s))
        return got["j"][1]

    sample_sonar_euler(tmodel, torch.from_numpy(x0).bfloat16(), torch.from_numpy(sig))
    js.sample_sonar_euler(jmodel, jnp.asarray(x0).astype(jnp.bfloat16), jnp.asarray(sig),
                          method="python")
    (ts_, td), (js_, jd) = got["t"], got["j"]
    assert ts_.dtype == torch.float32 and float(ts_[0]) == float(js_[0]) == float(sig[0])
    assert td.dtype == torch.bfloat16
    jd = np.asarray(jnp.asarray(jd, jnp.float32))
    assert float(np.abs(td.float().numpy() - jd).max()) <= 2 * 2.0**-7 * np.abs(jd).max()


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_method_is_accepted_and_checked_as_in_jax(name):
    """``method="scan"`` and ``"python"`` both run the host loop; anything
    else raises the JAX package's ValueError."""
    sig = torch.from_numpy(_sigmas(3))
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32))
    model = _stub("torch")
    base = SAMPLERS[name](model, x0, sig, seed=2)
    for method in ("scan", "python"):
        assert torch.equal(SAMPLERS[name](model, x0, sig, seed=2, method=method), base)
    with pytest.raises(ValueError, match="method must be 'scan' or 'python'"):
        SAMPLERS[name](model, x0, sig, seed=2, method="while")
    with pytest.raises(ValueError, match="method must be 'scan' or 'python'"):
        JSAMPLERS[name](_stub("jax"), jnp.asarray(x0.numpy()), jnp.asarray(sig.numpy()),
                        seed=2, method="while")


# ---------------------------------------------------------------------------
# the port's own noise through the sampler: resume, the tail, config 3a
# ---------------------------------------------------------------------------


def _config_3a_noise():
    """bench.py:468-471: scheduled time-brownian power noise, gaussian outside."""
    return ScheduledNoise(
        noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
        start_sigma=14.7, end_sigma=0.3, fallback_noise=get_noise_item("gaussian"))


@pytest.mark.parametrize("noise", ["brownian", "config3a", "gaussian"])
@pytest.mark.parametrize("stop", [1, 3])
def test_stop_and_resume_is_bitwise(noise, stop):
    sig = torch.from_numpy(_sigmas(5))
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32))
    model = _stub("torch")
    kw = dict(seed=11, noise_item=_config_3a_noise() if noise == "config3a"
              else get_noise_item(noise))
    full = sample_sonar_dpmpp_sde(model, x0, sig, **kw)
    _, carry = sample_sonar_dpmpp_sde(model, x0, sig, stop_step=stop, return_state=True, **kw)
    assert carry[2]["counter"] == 2 * stop  # two draws a step
    resumed = sample_sonar_dpmpp_sde(model, x0, sig, resume_from=carry, start_step=stop, **kw)
    assert torch.equal(full, resumed)
    assert not torch.equal(full, sample_sonar_dpmpp_sde(model, x0, sig,
                                                        **{**kw, "seed": 12}))


def test_tail_draws_twice_and_calls_the_model_once():
    """The ``sigma_next == 0`` tail runs the momentum step alone, with one
    model call, and advances the noise state by the two unused draws the JAX
    package's scan makes there: a run's final state counts two draws for
    every step, the tail included, and the Brownian cache ends at u = 0."""
    sig = torch.from_numpy(_sigmas(4))
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32))
    calls = []

    def model(x, s, **_):
        calls.append(float(s[0]))
        return _stub("torch")(x, s)

    out, carry = sample_sonar_dpmpp_sde(model, x0, sig, seed=3, return_state=True)
    assert len(calls) == 2 * 3 + 1 and bool(torch.isfinite(out).all())
    assert carry[2]["counter"] == 2 * 4
    assert carry[2]["node"]["u_last"] == 0.0
    assert carry[1]["has"] is True
    # the tail's result is the plain momentum step's: no noise reaches it
    seen = []
    sample_sonar_dpmpp_sde(_stub("torch"), x0, sig, seed=3, callback=seen.append)
    assert [d["i"] for d in seen] == list(range(4)) and torch.equal(seen[-1]["x"], out)
    other = sample_sonar_dpmpp_sde(_stub("torch"), x0, sig, seed=3, s_noise=0.5,
                                   start_step=3, resume_from=(seen[-2]["x"], carry[1], ()),
                                   noise_sampler=lambda i, s, sn: torch.full(SHAPE, 1e6))
    assert bool(torch.isfinite(other).all()) and float(other.abs().max()) < 1e4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_config_3a_path_end_to_end(dtype):
    """The whole slice on the CPU: a narrow UNet through make_denoiser,
    ``sample_sonar_dpmpp_sde`` with momentum 0.95 and the config-3a noise
    (time-brownian power noise inside [0.3, 14.7], gaussian outside), seven
    steps and the tail."""
    _, tden = _unets()
    sig = torch.from_numpy(_sigmas(8))
    x0 = (torch.from_numpy(np.random.default_rng(6).standard_normal((1, 4, 16, 16))
                           .astype(np.float32)) * float(sig[0])).to(dtype)
    run = lambda seed: sample_sonar_dpmpp_sde(  # noqa: E731
        tden, x0, sig, sonar_config=TCfg(momentum=0.95), noise_item=_config_3a_noise(),
        seed=seed, return_state=True)
    out, carry = run(7)
    assert out.shape == x0.shape and out.dtype == dtype and bool(torch.isfinite(out).all())
    assert 0.1 < float(out.float().std()) < 100.0
    assert torch.equal(out, run(7)[0]) and not torch.equal(out, run(8)[0])
    node = carry[2]["node"]
    assert carry[2]["counter"] == 2 * 8
    # the last window step ends below end_sigma; the Brownian child stopped there
    assert 0.0 <= node["noise"]["u_last"] < 0.1 and node["noise"]["w_last"].dtype == torch.float32
    default = sample_sonar_dpmpp_sde(tden, x0, sig, seed=7)  # the default: brownian
    assert bool(torch.isfinite(default).all()) and not torch.equal(default, out)
