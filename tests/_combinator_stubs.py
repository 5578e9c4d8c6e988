"""Shared stubs for the combinator parity tests (``test_torch_combinators.py``,
``test_torch_blendfilter_ops.py``, ``test_torch_wavelet_noise.py``).

- ``JStub`` / ``TStub``: leaves that hand out row ``i`` of one numpy table
  per (tag, shape), ``i`` a counter in their state; with ``reads_ref`` they
  add half of the exemplar latent they are handed (``ctx.ref_like()``).
- ``choices``: a fixture that feeds the JAX package's ``jax.random`` inside
  ``noise.combinators`` and ``utils.misc`` and the port's choice functions
  (``repeat_choices``, ``random_choices``) and Philox uniforms from one
  stream of numpy uniforms, read in call order by each side.
- ``run_both``: draws from both samplers and holds each draw (relative to
  max(1, |JAX|)) and every stub's draw count.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.combinators as JC
import sonar_tpu.utils.misc as JM
import sonar_tpu_torch.kernels.hwrng as TH
import sonar_tpu_torch.noise.combinators as TC
from sonar_tpu.noise.base import NoiseItem as JItem
from sonar_tpu.noise.base import make_noise_sampler as j_make_noise_sampler
from sonar_tpu_torch.noise.base import NoiseItem as TItem
from sonar_tpu_torch.noise.base import make_noise_sampler

REL, REL_FFT = 1e-5, 1e-4
N_ROWS = 48
SIGMAS = [(14.6, 9.0), (9.0, 9.0), (9.0, 5.5), (5.5, 3.1), (3.1, 1.6), (1.6, 0.8),
          (0.8, 0.4), (0.4, 0.2), (0.2, 0.1), (0.1, 0.05), (0.05, 0.03), (0.03, 0.01)]


def close_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= rel * scale, (err, rel * scale)


def _table(tag, shape):
    rng = np.random.default_rng([zlib.crc32(tag.encode()), *shape])
    return (rng.standard_normal((N_ROWS,) + tuple(shape)) * 1.7 + 0.3).astype(np.float32)


class JStub(JItem):
    """A JAX leaf handing out table rows (pure: the row is indexed by its
    state's counter, so a traced ``lax.cond`` branch may call it)."""

    def __init__(self, factor=1.0, *, tag, reads_ref=False, normalize=None):
        super().__init__(factor, normalize=normalize, tag=tag, reads_ref=reads_ref)

    def init_state(self, ctx, key):
        return {"i": jnp.zeros((), jnp.int32)}

    def sample(self, ctx, state, key, sigma, sigma_next, *, normalized=True):
        noise = jnp.asarray(_table(self.tag, ctx.shape))[state["i"]].astype(ctx.dtype)
        ref = ctx.ref_like() if self.reads_ref else None
        if ref is not None:
            noise = noise + 0.5 * ref
        return self.apply_factor_normalize(noise, normalized=normalized), {"i": state["i"] + 1}


class TStub(TItem):
    def __init__(self, factor=1.0, *, tag, reads_ref=False, normalize=None):
        super().__init__(factor, normalize=normalize, tag=tag, reads_ref=reads_ref)

    def init_state(self, ctx, seed):
        return {"i": 0}

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        noise = torch.from_numpy(_table(self.tag, ctx.shape)[state["i"]]).to(ctx.dtype)
        ref = ctx.ref_like() if self.reads_ref else None
        if ref is not None:
            noise = noise + 0.5 * ref
        return self.apply_factor_normalize(noise, normalized=normalized), {"i": state["i"] + 1}


def stubs(*tags, reads_ref=False):
    """(JAX stubs, port stubs) for the tags."""
    return ([JStub(tag=t, reads_ref=reads_ref) for t in tags],
            [TStub(tag=t, reads_ref=reads_ref) for t in tags])


class Choices:
    """One stream of uniforms in [0, 1) (float32), read in call order by
    each side through its own cursor; integers are lo + floor(u·(hi - lo))."""

    def __init__(self, seed=5):
        self.u = np.random.default_rng(seed).random(200_000, dtype=np.float32)
        self.pos = {"jax": 0, "torch": 0}

    def uniforms(self, side, n):
        p = self.pos[side]
        self.pos[side] = p + n
        return self.u[p:p + n]

    def ints(self, side, n, lo, hi):
        u = self.uniforms(side, n)
        return lo + np.floor(u * np.float32(hi - lo)).astype(np.int64)

    def perm(self, side, n):
        return np.argsort(self.uniforms(side, n), kind="stable")


class _FakeRandom:
    def __init__(self, ch):
        self.ch = ch

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def split(self, key, num=2):
        return [key] * num

    def fold_in(self, key, data):
        return key

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        shape = tuple(shape)
        n = int(np.prod(shape)) if shape else 1
        u = jnp.asarray(self.ch.uniforms("jax", n), jnp.float32).reshape(shape)
        return (minval + jnp.floor(u * jnp.float32(maxval - minval)).astype(jnp.int32)).astype(
            dtype)

    def permutation(self, key, n):
        return jnp.asarray(self.ch.perm("jax", int(n)))

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        shape = tuple(shape)
        n = int(np.prod(shape)) if shape else 1
        return jnp.asarray(self.ch.uniforms("jax", n), dtype).reshape(shape)


class _FakeJax:
    def __init__(self, ch):
        self.random = _FakeRandom(ch)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def choices(monkeypatch):
    """Both packages' combinator choices (and ShuffledNoise's uniforms)
    from one table."""
    ch = Choices()
    fake = _FakeJax(ch)
    monkeypatch.setattr(JC, "jax", fake)
    monkeypatch.setattr(JM, "jax", fake)

    def repeat_choices(seed, length, permute):
        slot = int(ch.ints("torch", 1, 0, length)[0])
        if not permute:
            return slot, None, None, None
        mode, r2, r3 = (int(ch.ints("torch", 1, 0, hi)[0]) for hi in (2, TC.INT32_MAX,
                                                                       TC.INT32_MAX))
        return slot, mode, r2, r3

    def random_choices(seed, n, mix):
        perm = ch.perm("torch", n)
        if mix == 1 and n > 1:
            return (int(ch.ints("torch", 1, 0, n)[0]),)
        return tuple(int(v) for v in perm[:mix])

    def philox_rand(seed, shape, *, device, dtype=torch.float32, stream=0):
        u = ch.uniforms("torch", int(np.prod(shape)))
        return torch.from_numpy(u.copy()).reshape(tuple(shape)).to(device=device, dtype=dtype)

    monkeypatch.setattr(TC, "repeat_choices", repeat_choices)
    monkeypatch.setattr(TC, "random_choices", random_choices)
    monkeypatch.setattr(TH, "philox_rand", philox_rand)
    return ch


def stub_counts(state):
    """Every stub's draw count in the state tree, in a fixed order."""
    if isinstance(state, dict):
        if set(state) == {"i"}:
            return [int(state["i"])]
        return [c for k in sorted(state) for c in stub_counts(state[k])]
    if isinstance(state, (tuple, list)):
        return [c for s in state for c in stub_counts(s)]
    return []


def run_both(jitem, titem, shape, *, n=6, rel=REL, ref=None, sigmas=SIGMAS, normalized=True):
    """Draw ``n`` times from both; hold each draw and the stubs' counts."""
    jref = None if ref is None else jnp.asarray(ref)
    tref = None if ref is None else torch.from_numpy(ref.copy())
    jfn, jst = j_make_noise_sampler(jitem, shape, seed=1, ref_latent=jref, normalized=normalized)
    tfn, tst = make_noise_sampler(titem, shape, seed=1, device="cpu", ref_latent=tref,
                                  normalized=normalized)
    outs = []
    for s, sn in sigmas[:n]:
        want, jst = jfn(jst, jnp.float32(s), jnp.float32(sn))
        got, tst = tfn(tst, s, sn)
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(shape)
        close_rel(got, want, rel)
        assert stub_counts(tst["node"]) == stub_counts(jst["node"])
        outs.append(got)
    return outs, jst, tst


def exemplar(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
