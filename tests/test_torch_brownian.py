"""The port's Brownian noise against the JAX package, on the CPU.

The two packages draw from different streams (Philox, threefry), so W is
held equal on injected normals: a table of numpy tensors, one per (fold,
cell), is fed to the port through ``normals=`` (or by patching
``brownian_normals``) and to the JAX package by patching the name ``jax``
that ``sonar_tpu.noise.brownian`` looks up, with a stand-in whose
``random.fold_in`` collects the path and whose ``random.normal`` reads the
table. Tolerance 1e-6 absolute on values of order 1: 17 float32
multiply-adds in the same order, XLA and torch rounding an fma differently.
What the stream itself must give (consistency, variance, independence) is
held by statistics on the port's own draws.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.brownian as jb
import sonar_tpu.noise.generators as jg
import sonar_tpu_torch.noise.brownian as tb
import sonar_tpu_torch.noise.generators as tg
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu_torch.noise import (BrownianGenerator, NoiseCtx, NoiseSamplerHandle,
                                   brownian_increment, brownian_w, brownian_w_at,
                                   get_noise_item, make_noise_sampler)

TOL = 1e-6
SHAPE = (1, 4, 8, 8)


def _table(levels, shape=SHAPE, seed=11):
    """table[0]: Z_0, (1, *shape); table[l + 1]: the 2^l cells of level l."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1 if j == 0 else 2 ** (j - 1), *shape)).astype(np.float32)
            for j in range(levels + 1)]


def _fake_jax(table):
    """Stands in for ``jax`` inside sonar_tpu.noise.brownian: keys are
    paths, a normal is a table row (the cell may be a traced index)."""
    def fold_in(key, i):
        return (*key, i)

    def normal(key, shape, dtype=jnp.float32):
        j, k = (key[0], 0) if len(key) == 1 else key
        return jnp.asarray(table[j])[k].astype(dtype).reshape(shape)

    return types.SimpleNamespace(random=types.SimpleNamespace(fold_in=fold_in, normal=normal))


def _torch_normals(table, dtype=torch.float32):
    return lambda j, k: torch.from_numpy(table[j][k]).to(dtype)


@pytest.mark.parametrize("levels", [4, 10])
@pytest.mark.parametrize("u", [0.0, 1.0, 0.3, 0.5, 0.625, 0.9999, -0.2, 1.5, 1e-4])
def test_brownian_w_matches_jax_on_injected_normals(monkeypatch, levels, u):
    table = _table(levels)
    monkeypatch.setattr(jb, "jax", _fake_jax(table))
    ref = jb.brownian_w((), jnp.float32(u), SHAPE, levels=levels)
    out = brownian_w(0, u, SHAPE, levels=levels, normals=_torch_normals(table))
    assert out.shape == SHAPE and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    # the injected tensors are read, not changed
    assert np.array_equal(table[0], _table(levels)[0])


@pytest.mark.parametrize("t0,t1", [(14.6, 9.0), (9.0, 2.5), (0.5, 0.03), (3.0, 3.0),
                                   (0.03, 14.6), (2.0, 0.0)])
@pytest.mark.parametrize("given_w0", [False, True])
def test_brownian_increment_matches_jax(monkeypatch, t0, t1, given_w0):
    levels, lo, hi = 8, np.float32(0.03), np.float32(14.6)
    table = _table(levels)
    monkeypatch.setattr(jb, "jax", _fake_jax(table))
    nt = _torch_normals(table)
    jw0 = tw0 = None
    if given_w0:
        jw0 = jb.brownian_w_at((), jnp.float32(t0), SHAPE, t_lo=jnp.float32(lo),
                               t_hi=jnp.float32(hi), levels=levels)
        tw0 = brownian_w_at(0, t0, SHAPE, t_lo=lo, t_hi=hi, levels=levels, normals=nt)
        np.testing.assert_allclose(tw0.numpy(), np.asarray(jw0), atol=TOL, rtol=0)
    rinc, rw1 = jb.brownian_increment((), jnp.float32(t0), jnp.float32(t1), SHAPE,
                                      t_lo=jnp.float32(lo), t_hi=jnp.float32(hi),
                                      levels=levels, w0=jw0)
    inc, w1 = brownian_increment(0, t0, t1, SHAPE, t_lo=lo, t_hi=hi, levels=levels,
                                 w0=tw0, normals=nt)
    assert bool(torch.isfinite(inc).all())
    np.testing.assert_allclose(w1.numpy(), np.asarray(rw1), atol=TOL, rtol=0)
    # the increment divides by sqrt(|t1 - t0|): relative to its own size
    scale = max(1.0, float(np.abs(np.asarray(rinc)).max()))
    np.testing.assert_allclose(inc.numpy(), np.asarray(rinc), atol=4 * TOL * scale, rtol=0)
    if t0 == t1:
        assert float(inc.abs().max()) == 0.0  # denom == 0 -> 1, and W(t1) - W(t0) = 0


def test_brownian_w_low_precision_rounds_the_coefficient_as_jax(monkeypatch):
    """bfloat16: the tent coefficient is rounded to the draw's type before
    it multiplies, as ``(scale * tri).astype(dtype)`` does. Tolerance: two
    bf16 ulps of the largest value (the accumulation rounds at each add on
    both sides, in another order inside an fma)."""
    table = _table(6)
    monkeypatch.setattr(jb, "jax", _fake_jax(table))
    ref = jb.brownian_w((), jnp.float32(0.37), SHAPE, levels=6, dtype=jnp.bfloat16)
    out = brownian_w(0, 0.37, SHAPE, levels=6, dtype=torch.bfloat16,
                     normals=_torch_normals(table, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert float(np.abs(out.float().numpy() - ref).max()) <= 2 * 2.0**-7 * np.abs(ref).max()


def test_generator_matches_jax_through_the_cache(monkeypatch):
    """BrownianGenerator against the JAX generator on one table, levels=4
    (the JAX side traces both branches of its ``lax.cond``, so the cell is a
    traced index into the table): a miss, a hit, then a miss again."""
    levels = 4
    table = _table(levels)
    monkeypatch.setattr(jb, "jax", _fake_jax(table))
    monkeypatch.setattr(tb, "brownian_normals",
                        lambda seed, shape, *, device, dtype: _torch_normals(table, dtype))
    lo, hi = np.float32(0.03), np.float32(14.6)
    jgen, tgen = jg.BrownianGenerator(levels=levels), BrownianGenerator(levels=levels)
    jctx = JCtx(shape=SHAPE, dtype=jnp.float32, sigma_min=jnp.float32(lo),
                sigma_max=jnp.float32(hi))
    tctx = NoiseCtx(shape=SHAPE, device="cpu", sigma_min=float(lo), sigma_max=float(hi))
    jst, tst = jgen.init_state(jctx, ()), tgen.init_state(tctx, 0)
    pairs = [(14.6, 9.0), (9.0, 4.0), (6.0, 1.0), (1.0, 0.0)]
    hits = []
    for s, sn in pairs:
        hits.append(abs(float(tb.unit_time(s, lo, hi)) - tst["u_last"]) < 1e-6)
        before = dict(tst)
        rn, jst = jgen.generate(jctx, jst, None, jnp.float32(s), jnp.float32(sn))
        n, new = tgen.generate(tctx, tst, 0, s, sn)
        assert tst == before and tst["w_last"] is before["w_last"]  # input state untouched
        tst = new
        scale = max(1.0, float(np.abs(np.asarray(rn)).max()))
        np.testing.assert_allclose(n.numpy(), np.asarray(rn), atol=4 * TOL * scale, rtol=0)
        np.testing.assert_allclose(tst["u_last"], float(jst["u_last"]), atol=1e-7)
        np.testing.assert_allclose(tst["w_last"].numpy(), np.asarray(jst["w_last"]),
                                   atol=TOL, rtol=0)
    assert hits == [False, True, False, True]
    assert tst["u_last"] == 0.0  # sigma_next = 0 lies below sigma_min: clipped


def _count_draws(monkeypatch):
    calls = []
    real = tb.philox_randn

    def counting(seed, shape, **kw):
        calls.append(seed)
        return real(seed, shape, **kw)

    monkeypatch.setattr(tb, "philox_randn", counting)
    return calls


def test_cache_hit_and_miss_cost_and_agree(monkeypatch):
    """A hit evaluates W once (levels + 1 draws), a miss twice, and both give
    the bits a fresh state gives: W is a function of (seed, u) alone."""
    calls = _count_draws(monkeypatch)
    gen = BrownianGenerator()
    ctx = NoiseCtx(shape=SHAPE, device="cpu", sigma_min=0.03, sigma_max=14.6)
    st0 = gen.init_state(ctx, 5)
    a, st1 = gen.generate(ctx, st0, 0, 14.6, 9.0)
    assert len(calls) == 2 * 17 and st0["u_last"] == -1e9
    del calls[:]
    b_hit, st2 = gen.generate(ctx, st1, 0, 9.0, 4.0)
    assert len(calls) == 17
    del calls[:]
    b_miss, st2m = gen.generate(ctx, st0, 0, 9.0, 4.0)
    assert len(calls) == 2 * 17
    assert torch.equal(b_hit, b_miss) and torch.equal(st2["w_last"], st2m["w_last"])
    assert st2["u_last"] == st2m["u_last"]
    # the seeds of one evaluation: fold 0, then (l + 1, k) for 16 levels; two
    # points share Z_0 and level 0's only cell
    assert len(set(calls)) == 2 * 17 - 2
    with pytest.raises(ValueError, match="sigma_min and sigma_max"):
        gen.init_state(NoiseCtx(shape=SHAPE, device="cpu"), 5)


def test_interval_consistency_is_exact():
    """W(a, c) = W(a, b) + W(b, c): W(u) is a pure function, so two
    evaluations agree bit for bit and the unnormalized increments add up to
    float32 rounding."""
    shape, kw = (1, 4, 16, 16), dict(t_lo=0.03, t_hi=14.6, device="cpu")
    a, b, c = 12.0, 7.5, 1.25
    assert torch.equal(brownian_w_at(3, b, shape, **kw), brownian_w_at(3, b, shape, **kw))
    ab, wb = brownian_increment(3, a, b, shape, **kw)
    bc, wc = brownian_increment(3, b, c, shape, w0=wb, **kw)
    ac, wc2 = brownian_increment(3, a, c, shape, **kw)
    assert torch.equal(wc, wc2)
    total = ab * np.sqrt(a - b) + bc * np.sqrt(b - c)
    assert float((ac * np.sqrt(a - c) - total).abs().max()) <= 1e-5
    assert not torch.equal(brownian_w_at(4, b, shape, **kw), wb)


def test_increments_have_unit_variance_and_are_independent():
    """16,384 elements an increment: std within 0.03 of 1 (its standard
    error is 0.0055) and disjoint increments correlate under 0.04
    (standard error 0.0078), at dyadic and non-dyadic endpoints."""
    shape, kw = (1, 4, 64, 64), dict(t_lo=0.0, t_hi=16.0, device="cpu")
    cuts = [16.0, 12.0, 9.3, 9.0, 4.0, 1.7, 0.11, 0.0]
    incs, w = [], None
    for t0, t1 in zip(cuts[:-1], cuts[1:]):
        inc, w = brownian_increment(9, t0, t1, shape, w0=w, **kw)
        incs.append(inc.double().flatten())
    for inc in incs:
        assert abs(float(inc.std()) - 1.0) < 0.03 and abs(float(inc.mean())) < 0.03
    corr = np.corrcoef(torch.stack(incs).numpy())
    assert float(np.abs(corr - np.eye(len(incs))).max()) < 0.04
    # W(1) on the unit interval is N(0, 1) itself
    assert abs(float(brownian_w(9, 1.0, shape, device="cpu").std()) - 1.0) < 0.03


def test_brownian_preset_through_the_sampler_protocol():
    kw = dict(seed=3, device="cpu", sigma_min=0.03, sigma_max=14.6)
    h1 = NoiseSamplerHandle(get_noise_item("brownian"), (1, 4, 16, 16), **kw)
    h2 = NoiseSamplerHandle(get_noise_item("brownian"), (1, 4, 16, 16), **kw)
    a, b = h1(14.6, 9.0), h2(14.6, 9.0)
    assert torch.equal(a, b) and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    assert abs(float(a.std()) - 1.0) < 0.1
    assert not torch.equal(a, h1(9.0, 4.0))
    fn, st = make_noise_sampler(get_noise_item("brownian"), (1, 4, 16, 16), **kw)
    _, st1 = fn(st, 14.6, 9.0)
    assert st["counter"] == 0 and st1["counter"] == 1 and st["node"]["u_last"] == -1e9
    other = NoiseSamplerHandle(get_noise_item("brownian"), (1, 4, 16, 16),
                               **{**kw, "seed": 4})(14.6, 9.0)
    assert not torch.equal(a, other)
    bf = NoiseSamplerHandle(get_noise_item("brownian"), (1, 4, 16, 16),
                            dtype=torch.bfloat16, **kw)(14.6, 9.0)
    assert bf.dtype == torch.bfloat16 and bool(torch.isfinite(bf).all())
    assert tg.BrownianGenerator.name == "brownian" and not tg.BrownianGenerator.DEFAULT_NORMALIZED
    with pytest.raises(ValueError, match="sigma_min and sigma_max"):
        NoiseSamplerHandle(get_noise_item("brownian"), (1, 4, 16, 16), seed=3, device="cpu")
