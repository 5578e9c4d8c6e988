"""The port's quantile normalization, latent operations and CFG-time
latent-op guider against the JAX package's, on the CPU.

Tolerance 1e-6 relative to max(1, |jax|) (elementwise float32 arithmetic in
the same order; the quantile's position and weights in the tensor's own type,
as ``jnp.quantile`` computes them). The sine and cosine strategies: 1e-5
(their argument reaches ~4π, where one float32 ulp is ~1e-6, and XLA
rewrites the reciprocal that scales it). bfloat16 quantiles: equal to the JAX
package's. Noise is held on injected draws: one numpy array behind a noise
item in each package, shaped by the sigma pair each package hands it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api.guider as jg
import sonar_tpu.cfg as jc
import sonar_tpu.core.normalize as jn
import sonar_tpu.noise.base as jbase
import sonar_tpu_torch.api.guider as tg
import sonar_tpu_torch.cfg as tc
import sonar_tpu_torch.core.normalize as tn
import sonar_tpu_torch.noise.base as tbase

SHAPE = (2, 4, 8, 8)


def _close(got, want, tol=1e-6):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, (err, tol * scale)


def _x(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 1.7


@pytest.mark.parametrize("strategy", sorted(jn.QUANTILE_HANDLERS))
def test_quantile_normalize_strategies_match_jax(strategy):
    """``pow_fac=1``: the default 0.5 takes a square root, whose slope near
    zero turns one ulp of a sine's or tanh's argument into ~1e-5 (see the
    next test for the root itself)."""
    x = _x()
    for kw in (dict(quantile=0.75), dict(quantile=-0.6),
               dict(quantile=[0.9, 0.7], dim=2, nq_fac=1.1), dict(quantile=0.8, flatten=False),
               dict(quantile=0.85, dim=None)):
        if kw.get("dim", 1) is None and strategy.startswith(("median", "mode")):
            continue  # tmedian/tmode take one axis in both packages
        want = jn.quantile_normalize(jnp.asarray(x), strategy=strategy, pow_fac=1.0, **kw)
        got = tn.quantile_normalize(torch.from_numpy(x), strategy=strategy, pow_fac=1.0, **kw)
        _close(got, want, 1e-5 if strategy.startswith(("sin", "cos")) else 1e-6)


@pytest.mark.parametrize("strategy", ["clamp", "scale_down", "tenth", "replace_2pt_flip",
                                      "mean", "median", "mode_1dec"])
@pytest.mark.parametrize("pow_fac", [0.5, 0.7, 0.0])
def test_quantile_normalize_pow_fac_matches_jax(strategy, pow_fac):
    x = _x(seed=7)
    for q in (0.75, -0.6):
        want = jn.quantile_normalize(jnp.asarray(x), quantile=q, strategy=strategy,
                                     pow_fac=pow_fac)
        _close(tn.quantile_normalize(torch.from_numpy(x), quantile=q, strategy=strategy,
                                     pow_fac=pow_fac), want)


def test_quantile_normalize_passes_through_and_refuses():
    x = torch.from_numpy(_x())
    for q in (1.0, -1.0, 1.5, None):
        assert tn.quantile_normalize(x, quantile=q) is x
    assert tn.quantile_normalize(torch.zeros(0)).numel() == 0
    with pytest.raises(ValueError, match="Unknown strategy"):
        tn.quantile_normalize(x, strategy="nope")
    got = tn.quantile_normalize(x, quantile=0.5, strategy_handler=lambda n, nq, **_: n * 0 + nq)
    want = jn.quantile_normalize(jnp.asarray(x.numpy()), quantile=0.5,
                                 strategy_handler=lambda n, nq, **_: n * 0 + nq)
    _close(got, want)


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.75, 0.999, 1.0])
def test_tquantile_matches_jnp_quantile_with_ties_and_bf16(q):
    ties = np.asarray([[3.0, 1.0, 1.0, 2.0, 2.0, 2.0, 5.0], [0.5] * 7], np.float32)
    for a in (ties, _x((3, 50), seed=3)):
        for dim in (-1, 0, None):
            want = jnp.quantile(jnp.asarray(a), q, axis=dim, keepdims=True, method="linear")
            _close(tn.tquantile(torch.from_numpy(a), q, dim=dim, keepdim=True), want)
            _close(tn.tquantile(torch.from_numpy(a), q, dim=dim),
                   jnp.quantile(jnp.asarray(a), q, axis=dim))
        bf = torch.from_numpy(a).bfloat16()
        want = jnp.quantile(jnp.asarray(a, jnp.bfloat16), q, axis=-1)
        got = tn.tquantile(bf, q, dim=-1)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_tmode_matches_jax():
    a = np.round(_x((3, 5, 40), seed=5), 1)
    for dim in (-1, 1, 0):
        _close(tn.tmode(torch.from_numpy(a), dim=dim), jn.tmode(jnp.asarray(a), axis=dim))
        _close(tn.tmode(torch.from_numpy(a), dim=dim, keepdim=True),
               jn.tmode(jnp.asarray(a), axis=dim, keepdims=True))


# ---------------------------------------------------------------------------
# latent operations
# ---------------------------------------------------------------------------

class _DrawJ(jbase.NoiseItem):
    """One fixed draw, times (1 + sigma_next): shows the sigma pair too."""

    def __init__(self, value):
        super().__init__(1.0)
        self.value = value

    def sample(self, ctx, state, key, sigma, sigma_next, *, normalized=True):
        return jnp.asarray(self.value) * (1.0 + (sigma_next if sigma_next is not None else 0)), state


class _DrawT(tbase.NoiseItem):
    def __init__(self, value):
        super().__init__(1.0)
        self.value = value

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        return torch.from_numpy(self.value) * (1.0 + (sigma_next if sigma_next is not None else 0)), state


def _mul(k):
    return lambda latent: latent * k


def _ext(k):
    def op(latent, *, sigma=None, **_kw):
        return latent * k + 0.25
    op.EXTENDED_LATENT_OPERATION = True
    return op


def _ops(mod, draw):
    return {
        "gate": mod.SonarLatentOperation(start_sigma=5.0, end_sigma=1.0, op=_ext(1.5)),
        "gate_plain": mod.SonarLatentOperation(op=_mul(0.5)),
        "advanced": mod.SonarLatentOperationAdvanced(
            blend_mode="lerp", blend_strength=0.7, input_multiplier=1.2, output_multiplier=1.0,
            difference_multiplier=0.9, ops=(_mul(0.8), _ext(1.1)), start_sigma=4.0,
            end_sigma=0.5, op_alt=_mul(2.0)),
        "advanced_fixed": mod.SonarLatentOperationAdvanced(
            output_multiplier=1.3, ops=(_ext(0.9),), strict_reference_compat=False),
        "noise": mod.SonarLatentOperationNoise(
            custom_noise=draw, scale_to_sigma=True, start_sigma=6.0, end_sigma=0.2,
            sample_sigmas=np.asarray([9.0, 3.0, 1.5, 0.5, 0.0], np.float32)),
        "noise_plain": mod.SonarLatentOperationNoise(custom_noise=draw),
        "quantile": mod.SonarLatentOperationQuantileFilter(quantile=0.8, strategy="tanh",
                                                           start_sigma=3.5),
    }


@pytest.mark.parametrize("name", ["gate", "gate_plain", "advanced", "advanced_fixed", "noise",
                                  "noise_plain", "quantile"])
def test_latent_operations_match_jax(name):
    x, draw = _x(seed=1), _x(seed=2)
    jop, top = _ops(jc, _DrawJ(draw))[name], _ops(tc, _DrawT(draw))[name]
    for sigma in (9.0, 3.0, 1.5, 0.3, None):
        want = jop(jnp.asarray(x), sigma=None if sigma is None else jnp.full((2,), sigma))
        got = top(torch.from_numpy(x), sigma=None if sigma is None else torch.full((2,), sigma))
        _close(got, want)
        if sigma is not None:  # the host sigma the port's guided calls carry
            got = top(torch.from_numpy(x), sigma=torch.full((2,), sigma),
                      raw_args={"sigma_host": sigma})
            _close(got, want)


def test_apply_operations_matches_jax():
    x, draw = _x(seed=3), _x(seed=4)
    jops, tops = _ops(jc, _DrawJ(draw)), _ops(tc, _DrawT(draw))
    names = ["advanced", "gate_plain", "quantile", "noise"]
    want = jc.apply_operations(jnp.asarray(x), [jops[n] for n in names] + [_mul(0.9)],
                               sigma=jnp.full((2,), 3.0))
    got = tc.apply_operations(torch.from_numpy(x), [tops[n] for n in names] + [_mul(0.9)],
                              sigma=torch.full((2,), 3.0))
    _close(got, want)


def test_noise_operation_seeds_from_the_sigma():
    """Without injected draws the port draws its own stream: one seed and
    sigma give one draw, another sigma another."""
    from sonar_tpu_torch.noise import get_noise_item

    op = tc.SonarLatentOperationNoise(custom_noise=get_noise_item("gaussian"), seed=3)
    x = torch.zeros(SHAPE)
    a = op(x, sigma=torch.full((2,), 2.0))
    assert torch.equal(a, op(x, sigma=torch.full((2,), 2.0)))
    assert not torch.equal(a, op(x, sigma=torch.full((2,), 2.5)))
    assert not torch.equal(a, op(x, sigma=torch.full((2,), 2.0), seed=11))
    assert 0.9 < float(a.std()) < 1.1


# ---------------------------------------------------------------------------
# make_latent_op_cfg_function: every mode and hook
# ---------------------------------------------------------------------------

MODES = ["cond", "cond_sub_uncond", "uncond", "uncond_sub_cond", "denoised",
         "denoised_sub_uncond", "model_input"]


def _args(lib, mode, sigma, with_uncond=True):
    x, c, u, d = (_x(seed=s) for s in (10, 11, 12, 13))
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    a = dict(input=conv(x), sigma=conv(np.full((2,), sigma, np.float32)), cond_scale=5.0,
             model_sampling=(jc if lib == "jax" else tc).DiscreteSampling())
    if lib == "torch":
        a["sigma_host"] = sigma
    if mode in ("denoised", "denoised_sub_uncond"):
        a.update(denoised=conv(d), uncond_denoised=conv(u) if with_uncond else None)
    elif mode != "model_input":
        a["conds_out"] = [conv(c), conv(u)] if with_uncond else [conv(c)]
    return a


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", [
    dict(),
    dict(pred_flip_mode=True, blend_mode="inject", blend_scale_mode="sampling"),
    dict(immediate_blend=True, blend_scale_mode="enabled_range_sin", blend_scale_offset=0.1),
    dict(start_sigma=6.0, end_sigma=1.0, blend_scale_mode="reverse_enabled_range",
         blend_scale_max=0.8),
    dict(start_sigma=2.0, end_sigma=2.0, require_uncond=True),
])
def test_latent_op_cfg_function_matches_jax(mode, variant):
    if mode == "model_input" and (variant.get("pred_flip_mode") or variant.get("require_uncond")):
        for mod in (jg, tg):
            with pytest.raises(ValueError):
                mod.make_latent_op_cfg_function(operation=_ext(1.3), mode=mode, **variant)
        return
    jp, jhook = jg.make_latent_op_cfg_function(operations=(_ext(1.3), _mul(0.7)), mode=mode,
                                               **variant)
    tp, thook = tg.make_latent_op_cfg_function(operations=(_ext(1.3), _mul(0.7)), mode=mode,
                                               **variant)
    assert thook == jhook
    for sigma in (12.0, 6.0, 3.0, 2.0, 0.5):
        for with_uncond in (True, False):
            want = jp(_args("jax", mode, sigma, with_uncond))
            got = tp(_args("torch", mode, sigma, with_uncond))
            if isinstance(want, (list, tuple)):
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    _close(g, w)
            else:
                _close(got, want)


def test_latent_op_cfg_function_without_operations_passes_through():
    for mode in MODES:
        tp, thook = tg.make_latent_op_cfg_function(mode=mode)
        jp, jhook = jg.make_latent_op_cfg_function(mode=mode)
        assert thook == jhook
        a = _args("torch", mode, 3.0)
        out = tp(a)
        if mode == "model_input":
            assert out is a["input"]
        elif mode.startswith("denoised"):
            assert out is a["denoised"]
        else:
            assert out is a["conds_out"]
