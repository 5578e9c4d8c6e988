"""``SonarPipeline`` of the port against the JAX package's, on the CPU, with a
narrow UNet (16 channels, mult (1, 2), attention at level 1) whose weights
are carried across by ``unet_params_from_jax``, on a 1×4×32×32 latent.

The two packages draw from different streams, so trajectories are held
equal on one injected numpy noise stream (``noise_sampler=``, with no noise
item: the port's samplers take ``noise_item`` before ``noise_sampler``).
Tolerance: 1e-4 relative to the trajectory's largest magnitude, as the
trajectories of the earlier slices (convolutions and chains of steps round
in another order in XLA and PyTorch); the latent contract
(``prepare_latent``/``finalize_latent``) 1e-6, one UNet forward through the
denoiser's overrides 1e-5.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api as japi
import sonar_tpu.cfg as jc
import sonar_tpu.models.unet as ju
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.cfg as tc
import sonar_tpu_torch.models.unet as tu
from sonar_tpu.samplers.momentum import SonarConfig as JCfg
from sonar_tpu_torch.noise import NoiseChain, get_noise_item
from sonar_tpu_torch.samplers.momentum import SonarConfig as TCfg

REL = 1e-4
SHAPE = (1, 4, 32, 32)
STEPS = 4
UNET_KW = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,), num_heads=2,
               norm_groups=4)
CONFIG3 = dict(wave="db4", level=3, padding_mode="periodization", high_precision_mode=False,
               diff=dict(yl_scale=8.0, yh_scales=[7.0, [6.0, 6.0, 7.0], "fill"],
                         scales_end=dict(yl_scale=6.0, yh_scales=6.0),
                         schedule="half_cosine", schedule_mode="sampling"))  # bench.py:472-477
REPO = pathlib.Path(__file__).resolve().parent.parent


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _sigmas(steps=STEPS):
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return np.concatenate([s, [0.0]]).astype(np.float32)


@pytest.fixture(scope="module")
def unets():
    jcfg = ju.UNetConfig(**UNET_KW)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    return jcfg, params, model.eval()


def _pairs(unets):
    """bench.py:413-422's cond/uncond pair (the uncond UNet sees x·c_in·0.97)
    and the batched form, for both packages."""
    jcfg, params, model = unets

    def j_den(scale):
        def den(x, sb, **_):
            s = sb.reshape(-1, 1, 1, 1)
            return x - s * ju.unet_apply(params, x / jnp.sqrt(1 + s**2) * scale, sb, jcfg)
        return den

    def t_den(scale):
        @torch.no_grad()
        def den(x, sb, **_):
            s = sb.reshape(-1, 1, 1, 1)
            return x - s * model(x / torch.sqrt(1 + s**2) * scale, sb)
        return den

    def j_batched(x2, sb2, **_):
        n = x2.shape[0]
        s = jnp.broadcast_to(sb2.reshape(-1), (n,)).reshape(-1, 1, 1, 1)
        half = jnp.where(jnp.arange(n).reshape(-1, 1, 1, 1) >= n // 2, 0.97, 1.0)
        return x2 - s * ju.unet_apply(params, x2 / jnp.sqrt(1 + s**2) * half,
                                      jnp.broadcast_to(sb2.reshape(-1), (n,)), jcfg)

    def t_batched(x2, sb2, **_):
        n = x2.shape[0]
        sb = sb2.reshape(-1).expand(n)
        s = sb.reshape(-1, 1, 1, 1)
        half = torch.where(torch.arange(n).reshape(-1, 1, 1, 1) >= n // 2, 0.97, 1.0)
        with torch.no_grad():
            return x2 - s * model(x2 / torch.sqrt(1 + s**2) * half, sb)

    return ((j_den(1.0), j_den(0.97), j_batched), (t_den(1.0), t_den(0.97), t_batched))


def _stream(n, seed=5):
    rng = np.random.default_rng(seed)
    noises = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]
    stacked = jnp.asarray(np.stack(noises))
    return (lambda i, s, sn: stacked[i]), (lambda i, s, sn: torch.from_numpy(noises[i]))


def _run(unets, *, batched=False, sampler="sonar_dpmpp_sde", steps=STEPS, jkw=None, tkw=None,
         **common):
    (jc_, ju_, jb), (tc_, tu_, tb) = _pairs(unets)
    sig = _sigmas(steps)
    x0 = (np.random.default_rng(1).standard_normal(SHAPE) * sig[0]).astype(np.float32)
    jns, tns = _stream(2 * steps)
    jmodels = dict(model_batched=jb) if batched else dict(model=jc_, model_uncond=ju_)
    tmodels = dict(model_batched=tb) if batched else dict(model=tc_, model_uncond=tu_)
    jp = japi.SonarPipeline(sampler=sampler, model_sampling=jc.DiscreteSampling(), seed=7,
                            **jmodels, **common, **(jkw or {}))
    tp = tapi.SonarPipeline(sampler=sampler, model_sampling=tc.DiscreteSampling(), seed=7,
                            **tmodels, **common, **(tkw or {}))
    ref = jax.jit(lambda x: jp(x, sig, noise_sampler=jns))(jnp.asarray(x0))
    out = tp(torch.from_numpy(x0), sig, noise_sampler=tns)
    return out, np.asarray(ref)


def test_config3_pipeline_matches_jax(unets):
    """BASELINE config 3 (bench.py:458-492) on injected noise: sonar_dpmpp_sde
    with momentum 0.95 and the config-3 wavelet CFG."""
    out, ref = _run(unets, cfg_scale=7.0,
                    jkw=dict(sonar_config=JCfg(momentum=0.95),
                             wavelet_cfg=jc.WaveletCFG(rules=jc.WCFGRules.build(**CONFIG3))),
                    tkw=dict(sonar_config=TCfg(momentum=0.95),
                             wavelet_cfg=tc.WaveletCFG(rules=tc.WCFGRules.build(**CONFIG3))))
    assert out.shape == SHAPE and out.dtype == torch.float32
    _close_rel(out, ref)


@pytest.mark.parametrize("batched", [False, True])
def test_basic_cfg_pipeline_matches_jax(unets, batched):
    """The baseline side of config 3's overhead: plain sonar_euler (momentum 1)
    with basic CFG at scale 7; pair and batched denoisers."""
    out, ref = _run(unets, batched=batched, sampler="sonar_euler", cfg_scale=7.0,
                    jkw=dict(sonar_config=JCfg(momentum=1.0)),
                    tkw=dict(sonar_config=TCfg(momentum=1.0)))
    _close_rel(out, ref)


def test_batched_equals_pair_in_the_port(unets):
    _, (tc_, tu_, tb) = _pairs(unets)
    sig = _sigmas()
    x0 = torch.from_numpy((np.random.default_rng(2).standard_normal(SHAPE) * 14.6)
                          .astype(np.float32))
    wcfg = tc.WaveletCFG(rules=tc.WCFGRules.build(**CONFIG3))
    kw = dict(sampler="sonar_euler_ancestral", model_sampling=tc.DiscreteSampling(), seed=3,
              wavelet_cfg=wcfg)
    pair = tapi.SonarPipeline(model=tc_, model_uncond=tu_, **kw)(x0, sig, noise_sampler=None)
    one = tapi.SonarPipeline(model_batched=tb, **kw)(x0, sig)
    _close_rel(one, pair, 1e-5)


@pytest.mark.parametrize("mode", ["cond_sub_uncond", "denoised", "model_input"])
def test_latent_op_hooks_match_jax(unets, mode):
    def op(mod):
        return dict(operation=mod.SonarLatentOperationQuantileFilter(
            quantile=0.9, strategy="clamp", pow_fac=1.0), mode=mode, blend_strength=0.6,
            start_sigma=10.0, end_sigma=0.5)

    jpatch = japi.make_latent_op_cfg_function(**op(jc))
    tpatch = tapi.make_latent_op_cfg_function(**op(tc))
    assert tpatch[1] == jpatch[1]
    out, ref = _run(unets, sampler="sonar_euler_ancestral", cfg_scale=5.0,
                    jkw=dict(latent_op_cfg=jpatch), tkw=dict(latent_op_cfg=tpatch))
    _close_rel(out, ref)


@pytest.mark.parametrize("flow", [False, True])
def test_prepare_and_finalize_latent_match_jax(flow):
    rng = np.random.default_rng(4)
    lat, noise = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    ms = (jc.Flow(shift=2.0), tc.Flow(shift=2.0)) if flow else (jc.DiscreteSampling(),
                                                                  tc.DiscreteSampling())
    for sig in ([0.9, 0.5, 0.2], [1.0, 0.3, 0.0]) if flow else (
            [14.6, 3.0, 0.0], [float(ms[0].sigma_max), 1.0, 0.5], [2.0, 1.0, 0.1]):
        sig = np.asarray(sig, np.float32)
        jp = japi.SonarPipeline(model=lambda x, s: x, model_sampling=ms[0])
        tp = tapi.SonarPipeline(model=lambda x, s: x, model_sampling=ms[1])
        want = jp.prepare_latent(jnp.asarray(lat), jnp.asarray(noise), sig)
        got = tp.prepare_latent(torch.from_numpy(lat), torch.from_numpy(noise), sig)
        _close_rel(got, want, 1e-6)
        if flow and sig[-1] >= 1.0 - 1e-6:
            continue
        _close_rel(tp.finalize_latent(torch.from_numpy(lat), torch.from_numpy(sig)),
                   jp.finalize_latent(jnp.asarray(lat), sig), 1e-6)
    if flow:
        with pytest.raises(ValueError, match="pure noise"):
            tp.finalize_latent(torch.from_numpy(lat), np.asarray([1.0, 1.0], np.float32))
    got = tp.prepare_latent(torch.from_numpy(lat), torch.from_numpy(noise), sig,
                            prediction="eps")
    want = jp.prepare_latent(jnp.asarray(lat), jnp.asarray(noise), sig, prediction="eps")
    _close_rel(got, want, 1e-6)


def test_flow_routing_matches_jax():
    """Flow model sampling gives an ancestral sampler the rectified-flow
    split, and warns for a noise-injecting sampler without one."""
    stub_t = lambda x, s, **_: x * 0.8  # noqa: E731
    stub_j = lambda x, s, **_: x * 0.8  # noqa: E731
    sig = np.asarray([1.0, 0.7, 0.4, 0.1, 0.0], np.float32)
    x0 = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    jns, tns = _stream(8, seed=9)
    jp = japi.SonarPipeline(model=stub_j, model_sampling=jc.Flow(), seed=1)
    tp = tapi.SonarPipeline(model=stub_t, model_sampling=tc.Flow(), seed=1)
    _close_rel(tp(torch.from_numpy(x0), sig, noise_sampler=tns),
               jp(jnp.asarray(x0), sig, noise_sampler=jns))
    with pytest.warns(UserWarning, match="over-noised"):
        tapi.SonarPipeline(model=stub_t, model_sampling=tc.Flow(), sampler="sonar_dpmpp_sde")(
            torch.from_numpy(x0), sig, noise_sampler=tns)


def test_jit_runner_forwards_extra_args(unets):
    """``jit()`` runs eagerly and hands ``extra_args`` to the denoiser: the
    weights of a ``params_kwarg`` override reach the UNet."""
    import copy

    jcfg, params, model = unets
    other = tu.unet_params_from_jax(jax.tree.map(
        np.asarray, jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(7), jcfg)))
    moved = copy.deepcopy(model)
    moved.load_state_dict(other)
    sig = _sigmas(3)
    x0 = torch.from_numpy((np.random.default_rng(3).standard_normal(SHAPE) * 14.6)
                          .astype(np.float32))
    kw = dict(sampler="sonar_euler_ancestral", seed=1)
    pipe = tapi.SonarPipeline(model=tu.make_denoiser(model, params_kwarg="w"), **kw)
    base = pipe.jit()(x0, sig)
    torch.testing.assert_close(base, pipe(x0, sig), rtol=0, atol=0)
    swapped = pipe.jit()(x0, sig, extra_args={"w": other})
    want = tapi.SonarPipeline(model=tu.make_denoiser(moved), **kw)(x0, sig)
    torch.testing.assert_close(swapped, want, rtol=0, atol=0)
    assert not torch.equal(swapped, base)


@pytest.mark.parametrize("prediction", ["eps", "flow"])
def test_make_denoiser_overrides_match_jax(unets, prediction):
    """``params_kwarg`` (a weight tree at call time) and ``timestep_fn`` (the
    network conditioned on sigma·1000, the preconditioning on the true
    sigma) against the JAX package's ``make_denoiser``."""
    jcfg, params, model = unets
    other = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(5), jcfg)
    jd = ju.make_denoiser(params, jcfg, prediction=prediction, params_kwarg="uncond_params",
                          timestep_fn=jc.Flow().timestep)
    td = tu.make_denoiser(model, prediction=prediction, params_kwarg="uncond_params",
                          timestep_fn=tc.Flow().timestep)
    x = np.random.default_rng(8).standard_normal(SHAPE).astype(np.float32)
    s = np.asarray([0.6], np.float32)
    _close_rel(td(torch.from_numpy(x), torch.from_numpy(s)),
               jd(jnp.asarray(x), jnp.asarray(s)), 1e-5)
    tree = tu.unet_params_from_jax(jax.tree.map(np.asarray, other))
    _close_rel(td(torch.from_numpy(x), torch.from_numpy(s), uncond_params=tree),
               jd(jnp.asarray(x), jnp.asarray(s), uncond_params=other), 1e-5)


def test_sampler_registry():
    assert sorted(tapi.SAMPLERS) == sorted(japi.SAMPLERS) and len(tapi.SAMPLERS) == 31
    for name in ("restart", "dpmpp_2m", "uni_pc", "dpm_adaptive"):
        assert tapi.SonarPipeline(sampler=name).sampler is tapi.get_sampler(name)
        assert tapi.get_sampler(name).__name__ == japi.get_sampler(name).__name__
    with pytest.raises(ValueError, match="Unknown sampler 'bogus'"):
        tapi.get_sampler("bogus")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tapi.SonarPipeline(model_batched=lambda x, s: x, model_uncond=lambda x, s: x)
    with pytest.raises(ValueError, match="requires a model"):
        tapi.SonarPipeline()(torch.zeros(SHAPE), _sigmas())
    over = tapi.sampler_config_override("sonar_euler", eta=0.3, sonar_config=TCfg(momentum=1.0))
    assert over.__name__ == "override_sample_sonar_euler"


def test_noisy_latent_like_and_noise_image_run_on_the_tensors_device():
    lat = torch.zeros(SHAPE)
    out = tapi.noisy_latent_like(lat, seed=3, mul_by_sigmas=_sigmas(),
                                 model_sampling=tc.DiscreteSampling(), add_to_latent=True,
                                 repeat_batch=2)
    assert out.shape == (2, *SHAPE[1:]) and out.device.type == "cpu"
    assert 14.0 < float(out.std()) < 15.2  # scaled to sigma_0 = 14.6
    with pytest.raises(ValueError, match="model_sampling"):
        tapi.noisy_latent_like(lat, mul_by_sigmas=_sigmas())
    img = torch.full((2, 8, 8, 3), 0.5)
    noisy = tapi.noise_image(img, seed=1, channel_mode="RG")
    assert noisy.shape == img.shape and float(noisy.min()) >= 0.0 and float(noisy.max()) <= 1.0
    assert torch.equal(noisy[..., 2], img[..., 2]) != torch.equal(noisy[..., 1], img[..., 1])
    first, second = tapi.split_noise_chain(NoiseChain([get_noise_item("gaussian")]))
    assert first.chain_factor == 1.0 and second is None


def test_api_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import sonar_tpu_torch.api, sonar_tpu_torch.cfg, sonar_tpu_torch.wavelets\n"
        "import sonar_tpu_torch.samplers.schedules\n"
        "bad = [m for m in ('jax', 'jaxlib', 'sonar_tpu', 'scipy', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
