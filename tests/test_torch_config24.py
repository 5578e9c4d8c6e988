"""BASELINE configs 2 and 4 (tools/bench_configs.py:33-96) through the port's
``SonarPipeline`` against the JAX package's, on the CPU, with a narrow UNet
(8 channels, mult (1, 2, 4): the 32-channel 8×8 level and the first block
on the way up are FreeU's stage 1) whose weights are carried across by
``unet_params_from_jax`` and redrawn at full scale, so the UNet and its
patches move the trajectory. 1×4×32×32 latent, 4 Karras steps.

- config 4: ``sonar_euler`` with momentum 0.95, wavelet CFG with per-band
  and per-orientation scales (``yh_scales=[[7.0, 6.5, 7.5], [6.0, 6.0,
  7.0], "fill"]``), FreeU-Extreme block patches on the cond UNet only;
- config 2: ``sonar_euler_ancestral`` with momentum 0.95 and CFG 7; its
  ``NoiseChain`` of ``perlin`` (0.6) and ``onef_pinkish`` (0.4) is held on
  shared numpy draws, one draw, since the two packages' streams differ.

Trajectories run on one injected numpy noise stream. Tolerance: 1e-4
relative to the trajectory's largest magnitude (as
tests/test_torch_pipeline.py); the chain's draw 1e-5 relative to max(1,
|JAX|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api as japi
import sonar_tpu.cfg as jc
import sonar_tpu.core.rng as JR
import sonar_tpu.models.unet as ju
import sonar_tpu.noise as jn
import sonar_tpu.noise.generators as JG
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.cfg as tc
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.noise.generators as TG
from sonar_tpu.noise.power import PowerFilter as JPF
from sonar_tpu.samplers.momentum import SonarConfig as JCfg
from sonar_tpu_torch.noise import NoiseChain, NoiseCtx, get_noise_item
from sonar_tpu_torch.noise.power import PowerFilter as TPF
from sonar_tpu_torch.samplers.momentum import SonarConfig as TCfg

REL = 1e-4
SHAPE = (1, 4, 32, 32)
STEPS = 4
UNET_KW = dict(model_channels=8, channel_mult=(1, 2, 4), attention_levels=(2,), num_heads=2,
               norm_groups=4)
CONFIG4_WCFG = dict(  # tools/bench_configs.py:84-90
    wave="db4", level=3, padding_mode="periodization", high_precision_mode=False,
    diff=dict(yl_scale=8.0, yh_scales=[[7.0, 6.5, 7.5], [6.0, 6.0, 7.0], "fill"],
              scales_end=dict(yl_scale=6.0, yh_scales=6.0), schedule="half_cosine",
              schedule_mode="sampling"))


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
    rng = np.random.default_rng(0)
    flat, treedef = jax.tree.flatten(params)
    # full-scale weights, norms near the identity
    leaves = [rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1])) if a.ndim >= 2
              else 0.1 * rng.standard_normal(a.shape) + (0.0 if a.sum() == 0 else 1.0)
              for a in flat]
    params = jax.tree.unflatten(treedef, [np.asarray(a, np.float32) for a in leaves])
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(params), assign=True)
    return jcfg, params, model.eval()


def _frux(mod, pf):
    """tools/bench_configs.py:65-67."""
    return mod.FreeUExtremeConfig(target="backbone", stage_1=True, scale=1.12, slice=0.75,
                                  sonar_power_filter=pf)


def _pairs(unets, jpatches, tpatches):
    """tools/bench_configs.py:72-81: the cond UNet with the patches, the
    uncond one on x·c_in·0.97 without."""
    jcfg, params, model = unets

    def j_den(scale, patches):
        def den(x, sb, **_):
            s = sb.reshape(-1, 1, 1, 1)
            c_in = 1.0 / jnp.sqrt(1.0 + s**2)
            return x - s * ju.unet_apply(params, x * c_in * scale, sb, jcfg,
                                         block_patches=patches)
        return den

    def t_den(scale, patches):
        @torch.no_grad()
        def den(x, sb, **_):
            s = sb.reshape(-1, 1, 1, 1)
            c_in = 1.0 / torch.sqrt(1.0 + s**2)
            return x - s * model(x * c_in * scale, sb, block_patches=patches)
        return den

    return ((j_den(1.0, jpatches), j_den(0.97, None)), (t_den(1.0, tpatches), t_den(0.97, None)))


def _inputs():
    rng = np.random.default_rng(1)
    x0 = (rng.standard_normal(SHAPE) * _sigmas()[0]).astype(np.float32)
    return x0, [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2 * STEPS)]


def _port_run(unets, sampler, tpatches=None, **kw):
    _, (tcond, tuncond) = _pairs(unets, None, tpatches)
    x0, noises = _inputs()
    tp = tapi.SonarPipeline(model=tcond, model_uncond=tuncond, sampler=sampler,
                            model_sampling=tc.DiscreteSampling(), seed=7, cfg_scale=7.0, **kw)
    out = tp(torch.from_numpy(x0), _sigmas(),
             noise_sampler=lambda i, s, sn: torch.from_numpy(noises[i]))
    assert out.shape == SHAPE and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    return out


def _jax_run(unets, sampler, jpatches=None, **kw):
    (jcond, juncond), _ = _pairs(unets, jpatches, None)
    x0, noises = _inputs()
    stacked = jnp.asarray(np.stack(noises))
    jp = japi.SonarPipeline(model=jcond, model_uncond=juncond, sampler=sampler,
                            model_sampling=jc.DiscreteSampling(), seed=7, cfg_scale=7.0, **kw)
    return np.asarray(jax.jit(lambda x: jp(x, _sigmas(), noise_sampler=lambda i, s, sn:
                                           stacked[i]))(jnp.asarray(x0)))


@pytest.mark.parametrize("mode,operator", [("1", None), ("0", "fft")])
def test_config4_pipeline_matches_jax(unets, mode, operator, monkeypatch):
    """Config 4 on injected noise, with each package's default spectral
    operator (dense K at these sizes) and with the FFT in both."""
    monkeypatch.setenv("SONAR_TPU_FREEU_MATMUL", mode)
    jpatches = jc.make_freeu_patches(model_sampling=jc.DiscreteSampling(), model_channels=8,
                                     input_config=_frux(jc, JPF(alpha=0.4)),
                                     output_config=_frux(jc, JPF(alpha=0.4)))
    tpatches = tc.make_freeu_patches(model_sampling=tc.DiscreteSampling(), model_channels=8,
                                     input_config=_frux(tc, TPF(alpha=0.4)),
                                     output_config=_frux(tc, TPF(alpha=0.4)), operator=operator)
    tkw = dict(sonar_config=TCfg(momentum=0.95),
               wavelet_cfg=tc.WaveletCFG(rules=tc.WCFGRules.build(**CONFIG4_WCFG)))
    out = _port_run(unets, "sonar_euler", tpatches, **tkw)
    ref = _jax_run(unets, "sonar_euler", jpatches, sonar_config=JCfg(momentum=0.95),
                   wavelet_cfg=jc.WaveletCFG(rules=jc.WCFGRules.build(**CONFIG4_WCFG)))
    _close_rel(out, ref)
    # the patches move the result
    unpatched = _port_run(unets, "sonar_euler", **tkw)
    assert float((out - unpatched).abs().max()) > 1e-3 * float(out.abs().max())


def test_config4_per_orientation_scales_match_jax():
    """One guided call of config 4's WCFG: the per-orientation scale spec
    expands to the same per-band, per-orientation scales as in JAX."""
    rng = np.random.default_rng(2)
    x, c, u = (rng.standard_normal(SHAPE).astype(np.float32) * k for k in (14.6, 1.0, 1.1))
    sig = _sigmas(30)

    def args(mod, arr, s):
        t = {k: arr(v) for k, v in (("input", x), ("cond_denoised", c), ("uncond_denoised", u))}
        return dict(t, sigma=arr(np.asarray([s], np.float32)), cond=t["input"] - t[
            "cond_denoised"], uncond=t["input"] - t["uncond_denoised"], cond_scale=7.0,
            model_sampling=mod.DiscreteSampling(), sample_sigmas=sig)

    for s in (14.6, 3.0, 0.5):
        want = jc.WaveletCFG(rules=jc.WCFGRules.build(**CONFIG4_WCFG))(args(jc, jnp.asarray, s))
        targs = args(tc, torch.from_numpy, s)
        got = tc.WaveletCFG(rules=tc.WCFGRules.build(**CONFIG4_WCFG))(
            dict(targs, sigma_host=s))
        _close_rel(got, want, 1e-5)


def test_config2_pipeline_matches_jax(unets):
    """Config 2's sampler and guidance on injected noise."""
    out = _port_run(unets, "sonar_euler_ancestral", sonar_config=TCfg(momentum=0.95))
    ref = _jax_run(unets, "sonar_euler_ancestral", sonar_config=JCfg(momentum=0.95))
    _close_rel(out, ref)


def test_config2_noise_chain_matches_jax(monkeypatch):
    """tools/bench_configs.py:40-43: perlin (0.6) + onef_pinkish (0.4),
    summed unnormalized and normalized once, on shared numpy draws (in call
    order; the keys and seeds are ignored)."""
    jt, tt = [], []

    def table(calls, kind, shape):
        rng = np.random.default_rng([3, len(calls)])
        calls.append((kind, tuple(int(d) for d in shape)))
        return (rng.standard_normal(shape) if kind == "normal" else rng.random(shape)).astype(
            np.float32)

    class FakeRandom:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        def split(self, key, num=2):
            return [key] * num

        def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
            lo, hi = jnp.asarray(minval, dtype), jnp.asarray(maxval, dtype)
            return jnp.maximum(lo, jnp.asarray(table(jt, "uniform", shape), dtype) * (hi - lo) + lo)

        def normal(self, key, shape=(), dtype=jnp.float32):
            return jnp.asarray(table(jt, "normal", shape), dtype)

    class FakeJax:
        random = FakeRandom()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(JG, "jax", FakeJax())
    monkeypatch.setattr(JR, "jax", FakeJax())
    for name, kind in (("philox_randn", "normal"), ("philox_rand", "uniform")):
        monkeypatch.setattr(TG, name, lambda seed, shape, *, device, dtype=torch.float32,
                            stream=0, _k=kind: torch.from_numpy(table(tt, _k, shape)).to(dtype))
    jchain = jn.NoiseChain([jn.get_noise_item("perlin", factor=0.6),
                            jn.get_noise_item("onef_pinkish", factor=0.4)])
    tchain = NoiseChain([get_noise_item("perlin", factor=0.6),
                         get_noise_item("onef_pinkish", factor=0.4)])
    jctx = jn.NoiseCtx(shape=SHAPE)
    want, _ = jchain.sample(jctx, jchain.init_state(jctx, jax.random.key(0)), jax.random.key(1),
                            jnp.float32(5.0), jnp.float32(4.0))
    tctx = NoiseCtx(shape=SHAPE, device="cpu")
    got, _ = tchain.sample(tctx, tchain.init_state(tctx, 0), 1, 5.0, 4.0)
    assert tt == jt and len(tt) == 4  # perlin: base + 2 angle fields; onef: 1 normal
    _close_rel(got, np.asarray(want), 1e-5)
