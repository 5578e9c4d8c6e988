"""Restart sampling of the port (``sonar_tpu_torch.samplers.restart``) against
the JAX package on the CPU.

``default_segments`` and ``restart_schedule`` are host numpy in both packages
and are held equal bit for bit. Trajectories share their jump noise: the JAX
module's ``jax.random.normal`` and the port's ``philox_randn`` are replaced by
one numpy table handed out in call order (keys and seeds ignored; both sides
must ask for the same number of draws), or, with ``custom_noise``, by a noise
item on each side that returns the table's draws and records the sigma pair
it was asked for. The inner samplers are deterministic (sonar_euler, euler,
dpmpp_2m) and take their derived seeds. Tolerance: 1e-4 relative to the
trajectory's largest magnitude (float32 steps rounding in another order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.base as jbase
import sonar_tpu.samplers as JS
import sonar_tpu.samplers.restart as JR
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.noise.base as tbase
import sonar_tpu_torch.samplers as TS
import sonar_tpu_torch.samplers.restart as TR

REL = 1e-4
SHAPE = (1, 4, 8, 8)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _sigmas(steps=10, tail=True):
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return (np.concatenate([s, [0.0]]) if tail else s).astype(np.float32)


def _stub(lib):
    target = np.arange(int(np.prod(SHAPE)), dtype=np.float32).reshape(SHAPE) / 100.0
    if lib == "jax":
        t = jnp.asarray(target)
        return lambda x, s, **_: (x * 0.9 + t) / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05)
    t = torch.from_numpy(target)
    return lambda x, s, **_: (x * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)


def _x0(sig):
    x0 = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * sig[0]
    return jnp.asarray(x0), torch.from_numpy(x0)


class _Table:
    """The k-th draw asked of the table, from numpy seeded by (seed, k)."""

    def __init__(self, seed=0):
        self.seed, self.calls = seed, []

    def draw(self, shape):
        rng = np.random.default_rng([self.seed, len(self.calls)])
        self.calls.append(tuple(shape))
        return rng.standard_normal(tuple(shape)).astype(np.float32)


class _FakeJax:
    """``jax`` for sonar_tpu.samplers.restart: random.normal hands out the
    table's draws; everything else is jax's."""

    def __init__(self, table):
        outer = self

        class _Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def normal(self, key, shape=(), dtype=jnp.float32):
                return jnp.asarray(outer.table.draw(shape), dtype)

        self.table, self.random = table, _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def shared(monkeypatch):
    jt, tt = _Table(7), _Table(7)
    monkeypatch.setattr(JR, "jax", _FakeJax(jt))

    def randn(seed, shape, *, device, dtype=torch.float32, stream=0):
        return torch.from_numpy(tt.draw(shape)).to(device=device, dtype=dtype)

    monkeypatch.setattr(TR, "philox_randn", randn)
    return jt, tt


@pytest.mark.parametrize("steps,tail", [(5, True), (10, True), (10, False), (30, True)])
def test_default_segments_and_schedules_equal_the_jax_packages(steps, tail):
    sig = _sigmas(steps, tail)
    for kw in (dict(), dict(n_restarts=2, segment_steps=3, k_repeats=1), dict(n_restarts=3)):
        got = TR.default_segments(torch.from_numpy(sig), **kw)
        assert [vars(s) for s in got] == [vars(s) for s in JR.default_segments(sig, **kw)]
    for n, t_min, t_max in ((4, 0.5, 2.0), (1, 0.03, 14.6), (8, 1e-5, 1.0), (3, 2.0, 2.5)):
        np.testing.assert_array_equal(TR.restart_schedule(n, t_min, t_max),
                                      JR.restart_schedule(n, t_min, t_max))
    for mod in (TR, JR):
        with pytest.raises(ValueError, match="degenerate"):
            mod.restart_schedule(4, 3.0, 3.0)


def _segs(mod, spec):
    return None if spec is None else [mod.RestartSegment(*a) for a in spec]


CASES = {
    "default": dict(),
    "two_segments": dict(segments=[(0.5, 2.0, 3, 2), (3.0, 8.0, 2, 1)]),
    "crossed": dict(segments=[(3.0, 8.0, 2, 1), (0.5, 9.0, 4, 3)]),
    "s_noise": dict(s_noise=0.7, segments=[(1.0, 4.0, 2, 2)]),
    "inner_euler": dict(inner="euler"),
    "inner_dpmpp_2m": dict(inner="dpmpp_2m", segments=[(0.5, 2.0, 3, 2)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_matches_jax(shared, case):
    kw = dict(CASES[case])
    inner = kw.pop("inner", None)
    segs = kw.pop("segments", None)
    sig = _sigmas()
    jx, tx = _x0(sig)
    ref = JR.sample_restart(_stub("jax"), jx, sig, seed=5, segments=_segs(JR, segs),
                            inner_sampler=inner and JS.SAMPLERS[inner], **kw)
    out = TR.sample_restart(_stub("torch"), tx, torch.from_numpy(sig), seed=5,
                            segments=_segs(TR, segs), inner_sampler=inner and TS.SAMPLERS[inner],
                            **kw)
    jt, tt = shared
    assert tt.calls == jt.calls and len(tt.calls) == sum(
        s.k for s in (_segs(TR, segs) or TR.default_segments(sig)))
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())
    _close_rel(out.numpy(), ref)


class _ItemJ(jbase.NoiseItem):
    def __init__(self, table, pairs):
        super().__init__(1.0)
        self.table, self.pairs = table, pairs

    def sample(self, ctx, state, key, sigma, sigma_next, *, normalized=True):
        self.pairs.append((float(sigma), float(sigma_next)))
        return jnp.asarray(self.table.draw(ctx.shape)), state


class _ItemT(tbase.NoiseItem):
    def __init__(self, table, pairs):
        super().__init__(1.0)
        self.table, self.pairs = table, pairs

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        self.pairs.append((sigma, sigma_next))
        return torch.from_numpy(self.table.draw(ctx.shape)), state


def test_restart_custom_noise_matches_jax():
    """The jump noise from a custom noise item, asked with (t_max, t_min)."""
    sig = _sigmas()
    jx, tx = _x0(sig)
    jp, tp = [], []
    segs = [(0.5, 2.0, 3, 2), (3.0, 8.0, 2, 2)]
    ref = JR.sample_restart(_stub("jax"), jx, sig, seed=2, segments=_segs(JR, segs),
                            custom_noise=_ItemJ(_Table(3), jp))
    out = TR.sample_restart(_stub("torch"), tx, torch.from_numpy(sig), seed=2,
                            segments=_segs(TR, segs), custom_noise=_ItemT(_Table(3), tp))
    assert len(tp) == len(jp) == 4 and all(a > b for a, b in tp)
    _close_rel(tp, jp, rel=1e-6)
    _close_rel(out.numpy(), ref)


def test_inner_calls_get_their_own_seeds_and_extra_args_seed_is_the_base():
    sig = torch.from_numpy(_sigmas())
    x0 = _x0(_sigmas())[1]
    seeds = []

    def inner(model, x, s, *, seed=None, **kw):
        seeds.append(seed)
        return TS.sample_euler_ancestral(model, x, s, seed=seed, **kw)

    a = TR.sample_restart(_stub("torch"), x0, sig, seed=9, inner_sampler=inner)
    assert len(seeds) == len(set(seeds)) == 4  # base, two repeats, tail
    b = TR.sample_restart(_stub("torch"), x0, sig, inner_sampler=inner, extra_args={"seed": 9})
    assert torch.equal(a, b)
    assert not torch.equal(a, TR.sample_restart(_stub("torch"), x0, sig, seed=10,
                                                inner_sampler=inner))


def test_segments_that_never_fire_warn_and_the_final_step_is_kept():
    sig = torch.from_numpy(_sigmas())
    x0 = _x0(_sigmas())[1]
    with pytest.warns(UserWarning, match="never fires"):
        out = TR.sample_restart(_stub("torch"), x0, sig, segments=[TR.RestartSegment(0.0, 1.0)])
    # a t_min at the trailing 0 skips the segment: the plain run remains
    assert torch.equal(out, TS.sample_sonar_euler(_stub("torch"), x0, sig,
                                                  seed=TR.derive_seed(TR.seed_from(None),
                                                                      "inner", 1)))


def test_restart_through_the_pipeline():
    sig = torch.from_numpy(_sigmas())
    x0 = _x0(_sigmas())[1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tapi.SonarPipeline(model=_stub("torch"), sampler="restart", seed=4)(x0, sig)
    assert torch.equal(out, TR.sample_restart(_stub("torch"), x0, sig, seed=4))
    assert not torch.equal(out, TS.sample_sonar_euler(_stub("torch"), x0, sig))
