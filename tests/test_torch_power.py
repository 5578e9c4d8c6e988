"""The port's power-spectrum noise and ScheduledNoise against the JAX
package, on the CPU.

The filter surface and the channel mixer are float64 numpy on the host in
both packages (the port keeps its own copy of that code): 1e-12 absolute.
The filtering itself (rfft2 · filter · irfft2, channel mix) runs on one
shared numpy input through both: 1e-5 absolute on values of order 1 (two
float32 FFTs, pocketfft on both sides, in another order of operations). The
draws come from different streams (Philox, threefry), so what is drawn is
held by statistics: the power spectrum of many draws against the filter.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.power as jp
import sonar_tpu_torch.noise.power as tp
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu_torch.noise import (NoiseCtx, NoiseSamplerHandle, PowerFilter,
                                   PowerFilterNoiseItem, PowerNoiseItem, ScheduledNoise,
                                   apply_channel_mixer, build_channel_mixer,
                                   get_noise_item, make_noise_sampler, rfft2_to_fft2)

FILTERS = [
    dict(),
    dict(alpha=1.0),
    dict(alpha=0.5, min_freq=0.05),
    dict(alpha=2.0, min_freq=0.1, max_freq=0.4, rel_bw=0.25),
    dict(alpha=-1.0, max_freq=0.3),
    dict(rotate=30.0, stretch=2.0, alpha=1.0),
    dict(rotate=-75.0, stretch=0.5, min_freq=0.02),
    dict(pnorm=1.0, alpha=0.5),
    dict(pnorm=4.0, min_freq=0.1, scale=0.7),
    dict(oversample=1, alpha=1.5),
    dict(oversample=2, min_freq=0.2, max_freq=0.1),  # max_freq is raised to min_freq
]
SIZES = [(16, 16), (17, 13), (8, 31), (32, 24)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kw", FILTERS, ids=[str(i) for i in range(len(FILTERS))])
def test_filter_surface_matches_jax(kw, size):
    ref = jp.PowerFilter(**kw).build(size)
    out = PowerFilter(**kw).build(size)
    assert out.shape == (size[0], size[1] // 2 + 1) and out.dtype == np.float64
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)
    over = PowerFilter(**kw).build((1, 4, *size), override_oversample=3)
    np.testing.assert_allclose(over, jp.PowerFilter(**kw).build(size, override_oversample=3),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("mix,nf", [(1.0, 1.0), (0.5, 1.0), (0.0, 1.0), (1.0, 0.0),
                                    (0.25, 0.5), (-1.0, 2.0)])
@pytest.mark.parametrize("size", [(16, 16), (17, 13)])
def test_filter_normalize_matches_jax(mix, nf, size):
    surface = PowerFilter(alpha=1.0, min_freq=0.03).build(size)
    ref = jp.PowerFilter.normalize(surface.copy(), size, mix=mix, normalization_factor=nf)
    out = PowerFilter.normalize(surface.copy(), size, mix=mix, normalization_factor=nf)
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)
    if mix == 1.0 and nf == 1.0:
        assert abs(math.sqrt(float(np.mean(out**2))) - 1.0) < 1e-12


@pytest.mark.parametrize("mode", ["max", "min", "add", "sub", "mul", "unknown"])
def test_filter_compose_matches_jax(mode):
    inner = dict(alpha=1.0, max_freq=0.2)
    outer = dict(min_freq=0.25, alpha=0.0, scale=0.5)
    ref = jp.PowerFilter(compose_with=jp.PowerFilter(**inner), compose_mode=mode,
                         **outer).build((16, 20))
    pf = PowerFilter(compose_with=PowerFilter(**inner), compose_mode=mode, **outer)
    np.testing.assert_allclose(pf.build((16, 20)), ref, atol=1e-12, rtol=0)
    assert float(pf.build((16, 20)).min()) >= 0.0
    np.testing.assert_allclose(pf.build((16, 20), composed=False),
                               PowerFilter(**outer).build((16, 20)), atol=0, rtol=0)
    assert pf.clone() is pf and hash(pf) == hash(pf.clone())


@pytest.mark.parametrize("c,common,corr", [
    (4, 0.5, "1, 1, 1, 1, 1, 1"), (4, 0.9, "1, 0.5, -0.25, 0.75, 0.1, 0.3"),
    (4, -0.3, "1, 1, 1"), (3, 0.7, [1.0, 0.2, 0.4]), (8, 0.25, "1"),
    (4, 0.0, "1, 1, 1, 1, 1, 1"), (4, None, "1"),
])
def test_channel_mixer_matches_jax(c, common, corr):
    ref = jp.build_channel_mixer(c, common, corr)
    out = build_channel_mixer(c, common, corr)
    if ref is None:
        assert out is None  # identity (or no common mode): the product is skipped
    else:
        np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-12)
    x = np.random.default_rng(0).standard_normal((2, c, 5, 6)).astype(np.float32)
    got = apply_channel_mixer(torch.from_numpy(x), out)
    want = jp.apply_channel_mixer(jnp.asarray(x), ref)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [(16, 16), (17, 13), (12, 9)])
@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("common", [0.0, 0.6])
def test_filtered_matches_jax_on_a_shared_input(size, spatial, common):
    h, w = size
    shape = (2, 4, h, w)
    kw = dict(alpha=1.0, min_freq=0.04, common_mode=common,
              channel_correlation="1, 0.5, 0.25, 1, 0.3, 0.8")
    jitem, titem = jp.PowerNoiseItem(**kw), PowerNoiseItem(**kw)
    rng = np.random.default_rng(3)
    if spatial:
        x = rng.standard_normal(shape).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        x = (rng.standard_normal((2, 4, h, w // 2 + 1))
             + 1j * rng.standard_normal((2, 4, h, w // 2 + 1))).astype(np.complex64)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jctx = JCtx(shape=shape, dtype=jnp.float32)
    tctx = NoiseCtx(shape=shape, device="cpu")
    filt = titem.make_filter(shape)
    np.testing.assert_allclose(filt, jitem.make_filter(shape), atol=1e-12, rtol=0)
    ftensor = titem.filter_tensor(tctx)
    assert ftensor.dtype == torch.float32 and ftensor.shape == (h, w // 2 + 1)
    assert titem.filter_tensor(tctx) is ftensor  # built once per (filter, shape, device)
    np.testing.assert_allclose(ftensor.numpy(), filt.astype(np.float32), atol=0, rtol=0)
    ref = jitem._filtered(jctx, jx, jnp.asarray(filt, jnp.float32), is_spatial=spatial)
    out = titem._filtered(tctx, tx, ftensor, is_spatial=spatial)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(8, 8), (9, 7), (8, 7), (9, 8)])
def test_rfft2_to_fft2_matches_jax(size):
    x = np.random.default_rng(1).standard_normal((2, *size)).astype(np.float32)
    r = np.fft.rfft2(x).astype(np.complex64)
    out = rfft2_to_fft2(torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), np.asarray(jp.rfft2_to_fft2(jnp.asarray(r))),
                               atol=1e-6, rtol=0)


def _mean_power(handle, draws, *args):
    acc = 0.0
    for _ in range(draws):
        n = handle(*args).double()
        acc = acc + (torch.fft.rfft2(n, norm="ortho").abs() ** 2).mean(dim=(0, 1))
    return (acc / draws).numpy()


@pytest.mark.parametrize("kw", [dict(alpha=1.0), dict(alpha=0.5, min_freq=0.05),
                                dict(alpha=2.0, max_freq=0.35)])
def test_drawn_power_spectrum_follows_the_filter(kw):
    """768 spectra (8 × 4 planes × 24 draws) of unnormalized rfft-domain
    noise: away from the self-conjugate columns E|rfft|² = 2·filter². The
    mean ratio over the bins is within 3 % of 1 (standard error 0.2 %) and
    log power follows log filter² with a correlation above 0.99."""
    shape = (8, 4, 32, 32)
    item = PowerNoiseItem(normalize=False, **kw)
    h = NoiseSamplerHandle(item, shape, seed=5, device="cpu")
    power = _mean_power(h, 24)[:, 1:-1]
    want = 2.0 * item.make_filter(shape)[:, 1:-1] ** 2
    keep = want > 1e-3 * want.max()
    ratio = power[keep] / want[keep]
    assert abs(float(ratio.mean()) - 1.0) < 0.03
    assert float(np.abs(ratio - 1.0).max()) < 0.35
    if kw != dict(alpha=0.0):
        assert np.corrcoef(np.log(power[keep]), np.log(want[keep]))[0, 1] > 0.99
    a = NoiseSamplerHandle(item, shape, seed=5, device="cpu")()
    assert torch.equal(a, NoiseSamplerHandle(item, shape, seed=5, device="cpu")())
    assert not torch.equal(a, NoiseSamplerHandle(item, shape, seed=6, device="cpu")())


def test_time_brownian_power_noise_statistics_and_state():
    """The Brownian increment is white, so its filtered spectrum follows
    filter² (correlation of the logs above 0.98 over 512 spectra), the draw
    is normalized, and the endpoint cache advances in the returned state
    only."""
    shape = (8, 4, 32, 32)
    item = PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True)
    kw = dict(seed=7, device="cpu", sigma_min=0.03, sigma_max=14.6)
    h = NoiseSamplerHandle(item, shape, **kw)
    sig = np.linspace(14.6, 0.03, 17).tolist()
    acc = 0.0
    for s, sn in zip(sig[:-1], sig[1:]):
        n = h(s, sn)
        assert abs(float(n.std()) - 1.0) < 0.02 and abs(float(n.mean())) < 0.02
        acc = acc + (torch.fft.rfft2(n.double(), norm="ortho").abs() ** 2).mean(dim=(0, 1))
    power = (acc / 16).numpy()[:, 1:-1]
    want = item.make_filter(shape)[:, 1:-1] ** 2
    keep = want > 1e-3 * want.max()
    assert np.corrcoef(np.log(power[keep]), np.log(want[keep]))[0, 1] > 0.98
    fn, st = make_noise_sampler(item, shape, **kw)
    _, st1 = fn(st, 14.6, 9.0)
    assert st["node"]["u_last"] == -1e9 and 0.0 < st1["node"]["u_last"] < 1.0
    assert float(st["node"]["w_last"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="stochastic samplers"):
        make_noise_sampler(item, shape, seed=7, device="cpu")


def test_low_precision_latents_filter_in_float32():
    shape = (1, 4, 16, 16)
    kw = dict(seed=2, device="cpu", sigma_min=0.03, sigma_max=14.6)
    for item in (PowerNoiseItem(alpha=1.0), PowerNoiseItem(alpha=1.0, time_brownian=True)):
        ref = NoiseSamplerHandle(item, shape, **kw)(10.0, 5.0)
        for dt in (torch.bfloat16, torch.float16):
            fn, st = make_noise_sampler(item, shape, dtype=dt, **kw)
            out, st = fn(st, 10.0, 5.0)
            assert out.dtype == dt and bool(torch.isfinite(out).all())
            if item.time_brownian:
                assert st["node"]["w_last"].dtype == torch.float32
            # the same float32 draw, rounded where the JAX package casts:
            # two ulps of the type on values up to ~4
            ulp = 2.0**-7 if dt == torch.bfloat16 else 2.0**-10
            assert float((out.float() - ref).abs().max()) <= 2 * ulp * 4.0


def test_power_filter_item_filters_its_inner_noise():
    shape = (2, 4, 16, 12)
    inner = get_noise_item("gaussian")
    item = PowerFilterNoiseItem(noise=inner, alpha=1.0, min_freq=0.03,
                                normalize_result=False)
    fn, st = make_noise_sampler(item, shape, seed=9, device="cpu")
    out, st1 = fn(st, 1.0, 0.5)
    ctx = NoiseCtx(shape=shape, device="cpu")
    from sonar_tpu_torch.core.rng import derive_seed
    raw, _ = inner.sample(ctx, st["node"]["inner"], derive_seed(st["seed"], 0), 1.0, 0.5,
                          normalized=False)
    want = torch.fft.irfft2(torch.fft.rfft2(raw, norm="ortho") * item.filter_tensor(ctx),
                            s=shape[-2:], norm="ortho")
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert set(st1["node"]) == {"inner"}
    with pytest.raises(ValueError, match="at least 4"):
        make_noise_sampler(item, (4, 16, 12), seed=9, device="cpu")


# ---------------------------------------------------------------------------
# ScheduledNoise
# ---------------------------------------------------------------------------


def _scheduled(**kw):
    return ScheduledNoise(
        noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
        start_sigma=14.7, end_sigma=0.3, fallback_noise=get_noise_item("gaussian"), **kw)


@pytest.mark.parametrize("sigma,inside", [
    (14.6, True), (14.7, True), (float(np.float32(14.7)), True),
    (float(np.nextafter(np.float32(14.7), np.float32(20))), False), (15.0, False),
    (0.3, True), (float(np.float32(0.3)), True),
    (float(np.nextafter(np.float32(0.3), np.float32(0))), False), (0.03, False),
])
def test_scheduled_noise_window_edges(sigma, inside):
    """The window is closed at both ends and compared in float32, as the JAX
    package compares its float32 sigma. Inside it the Brownian child draws
    and its cache advances; outside the fallback draws and the cache stays."""
    shape = (1, 4, 16, 16)
    fn, st = make_noise_sampler(_scheduled(), shape, seed=3, device="cpu", sigma_min=0.03,
                                sigma_max=15.0)
    out, st1 = fn(st, sigma, sigma * 0.5)
    assert out.shape == shape and bool(torch.isfinite(out).all())
    advanced = st1["node"]["noise"]["u_last"] != -1e9
    assert advanced == inside
    assert st["node"]["noise"]["u_last"] == -1e9 and st1["counter"] == 1
    assert set(st1["node"]) == {"noise", "fallback_noise"}


def test_scheduled_noise_agrees_with_its_children_and_jax_rules():
    shape = (1, 4, 16, 16)
    kw = dict(seed=3, device="cpu", sigma_min=0.03, sigma_max=14.6)
    from sonar_tpu_torch.core.rng import derive_seed
    item = _scheduled()
    fn, st = make_noise_sampler(item, shape, **kw)
    ctx = NoiseCtx(shape=shape, device="cpu", sigma_min=0.03, sigma_max=14.6)
    # children are initialised on derive_seed(seed, i), as fold_in(key, i)
    init = derive_seed(st["seed"], "init")
    assert st["node"]["noise"]["base"] == derive_seed(init, 0)
    inside, _ = fn(st, 5.0, 2.0)
    raw, _ = item.noise.sample(ctx, st["node"]["noise"], derive_seed(st["seed"], 0), 5.0, 2.0,
                               normalized=False)
    from sonar_tpu_torch.core.normalize import scale_noise
    assert torch.equal(inside, scale_noise(raw, 1.0, normalized=True))
    outside, _ = fn(st, 0.2, 0.1)
    graw, _ = item.fallback_noise.sample(ctx, None, derive_seed(st["seed"], 0), 0.2, 0.1,
                                         normalized=False)
    assert torch.equal(outside, scale_noise(graw, 1.0, normalized=True))
    with pytest.raises(ValueError, match="requires sigma, sigma_next"):
        fn(st, None, None)
    with pytest.raises(ValueError, match="requires sigma, sigma_next"):
        fn(st, 1.0, None)
    # no fallback: zeros outside the window, scaled by nothing
    bare = ScheduledNoise(noise=get_noise_item("gaussian"), start_sigma=2.0, end_sigma=1.0,
                          factor=0.5, normalize=False)
    bfn, bst = make_noise_sampler(bare, shape, **kw)
    z, _ = bfn(bst, 3.0, 2.5)
    assert float(z.abs().max()) == 0.0
    n, _ = bfn(bst, 1.5, 1.2)
    g, _ = get_noise_item("gaussian").sample(ctx, (), derive_seed(bst["seed"], 0), 1.5, 1.2,
                                             normalized=False)
    assert torch.equal(n, g * 0.5)
    # defaults: the window is [0, inf]
    assert ScheduledNoise(noise=bare).start_sigma == math.inf
    assert [k for k, v in itertools.islice(bare._children().items(), 2)] == [
        "noise", "fallback_noise"]
    with pytest.raises(ValueError, match="at most 4"):
        make_noise_sampler(_scheduled(), (1, 4, 2, 16, 16), **kw)


def test_power_item_keeps_the_jax_constructor():
    item = PowerNoiseItem(0.5, alpha=1.0, min_freq=0.1, rotate=10.0, mix=0.7)
    ref = jp.PowerNoiseItem(0.5, alpha=1.0, min_freq=0.1, rotate=10.0, mix=0.7)
    assert item.factor == 0.5 and item.mix == 0.7 and not item.time_brownian
    assert dataclass_dict(item.power_filter) == dataclass_dict(ref.power_filter)
    assert sorted(item.params()) == sorted(ref.params())
    assert tp.work_dtype(torch.bfloat16) == torch.float32
    assert tp.work_dtype(torch.float64) == torch.float64


def dataclass_dict(pf):
    import dataclasses

    return {f.name: getattr(pf, f.name) for f in dataclasses.fields(pf)}
