"""The port's Collatz chain noise (``noise/collatz.py``) against the JAX
package's, on the CPU, on shared seed arrays.

Both sides see the same seed arrays: stub ``seed_noise_sampler`` and
``mix_noise_sampler`` children that hand out rows of one numpy table
(``tests/_combinator_stubs.py``), or, without children, one stream of
numpy uniforms and normals in place of ``jax.random`` and of the port's
Philox draws. Every ``output_mode``, ``flatten``, ``seed_mode``,
``integer_math``, ``break_loops``, ``chain_offset`` 0 and ``dims`` are
covered. The chain itself (values, adds and muls of every step) is equal
bit for bit: the port rounds the two fused multiply-adds of XLA's compiled
step once, as XLA does. Each generator output is held elementwise within
1e-5 of max(1, |JAX|): the quantile normalization and the sum over
iterations round some elements one ulp apart, and the sign-flipped sum
cancels, so such an ulp is not small beside the element itself; a chain
element that a truncation or a loop break tipped would be far outside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.collatz as JC
import sonar_tpu_torch.noise.collatz as TC
from _combinator_stubs import stubs
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu_torch.noise import NoiseCtx

SHAPE = (1, 4, 16, 12)
MODES = ["values", "ratios", "seed_x_ratios", "noise_x_ratios", "mults", "seed_x_mults",
         "noise_x_mults", "adds", "seed_x_adds", "noise_x_adds"]


class _Stream:
    def __init__(self):
        rng = np.random.default_rng(21)
        self.u = (np.floor(rng.random(200_000) * 2**23) / 2**23).astype(np.float32)
        self.z = rng.standard_normal(200_000).astype(np.float32)
        self.pos = {}

    def take(self, kind, side, shape):
        n = int(np.prod(shape))
        p = self.pos.get((kind, side), 0)
        self.pos[(kind, side)] = p + n
        return getattr(self, kind)[p:p + n].reshape(tuple(shape))


class _FakeRandom:
    def __init__(self, st):
        self.st = st

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def split(self, key, num=2):
        return [key] * num

    def fold_in(self, key, data):
        return key

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert (minval, maxval) == (0.0, 1.0)
        return jnp.asarray(self.st.take("u", "jax", shape), dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.st.take("z", "jax", shape), dtype)


@pytest.fixture
def stream(monkeypatch):
    st = _Stream()
    monkeypatch.setattr(JC, "jax", type("FakeJax", (), {
        "random": _FakeRandom(st), "lax": jax.lax, "__getattr__": lambda s, n: getattr(jax, n)})())

    def rand(seed, shape, *, device, dtype=torch.float32, stream=0):
        return torch.from_numpy(st.take("u", "torch", shape).copy()).to(device=device, dtype=dtype)

    def randn(seed, shape, *, device, dtype=torch.float32, stream=0):
        return torch.from_numpy(st.take("z", "torch", shape).copy()).to(device=device, dtype=dtype)

    monkeypatch.setattr(TC, "philox_rand", rand)
    monkeypatch.setattr(TC, "philox_randn", randn)
    return st


def _hold(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


def _run(kw, shape=SHAPE, children=False, draws=1):
    """(port, JAX) outputs of ``draws`` draws of one generator."""
    if children:
        (js, jm), (ts, tm) = stubs("seed", "mix")
        kw = dict(kw, seed_noise_sampler=js, mix_noise_sampler=jm), dict(
            kw, seed_noise_sampler=ts, mix_noise_sampler=tm)
    else:
        kw = (kw, kw)
    jg, tg = JC.CollatzGenerator(**kw[0]), TC.CollatzGenerator(**kw[1])
    jctx, tctx = JCtx(shape), NoiseCtx(shape, device="cpu")
    jst, tst = jg.init_state(jctx, jax.random.key(0)), tg.init_state(tctx, 0)
    outs = []
    for _ in range(draws):
        want, jst = jg.generate(jctx, jst, jax.random.key(1), 1.0, 0.5)
        got, tst = tg.generate(tctx, tst, 1, 1.0, 0.5)
        outs.append((got.numpy(), np.asarray(want)))
    return outs


@pytest.mark.parametrize("mode", MODES)
def test_every_output_mode_matches_jax(mode, stream):
    for got, want in _run({"output_mode": mode, "iterations": 4}):
        _hold(got, want)


@pytest.mark.parametrize("mode", ["values", "noise_x_adds", "seed_x_mults"])
def test_children_match_jax(mode):
    """Stub seed and mix children: two draws, the children's counters advance
    alike (their state lives in the generator's)."""
    for got, want in _run({"output_mode": mode, "iterations": 3}, children=True, draws=2):
        _hold(got, want)


@pytest.mark.parametrize("kw", [
    {},  # the defaults: 10 iterations over dims (-1, -1, -2, -2)
    {"flatten": True, "dims": (2,), "iterations": 3},
    {"flatten": True, "dims": (1, -1), "chain_length": (4, 7), "iterations": 4},
    {"seed_mode": "force_odd", "iterations": 3},
    {"seed_mode": "force_even", "iterations": 3},
    {"integer_math": False, "iterations": 3},
    {"break_loops": False, "iterations": 3},
    {"chain_offset": 0, "iterations": 3},
    {"chain_offset": 0, "chain_length": (5,), "dims": (0, 1, 2), "iterations": 3},
    {"add_preserves_sign": False, "even_addition": 0.5, "iterations": 3},
    {"iteration_sign_flipping": False, "adjust_scale": True, "iterations": 3},
    {"quantile": 0, "rmin": -50.0, "rmax": 70.0, "iterations": 3},
    {"quantile": 0.8, "quantile_strategy": "tanh", "iterations": 2},
])
def test_options_match_jax(kw, stream):
    for got, want in _run(kw):
        _hold(got, want)


def test_5d_and_flat_children_match_jax():
    for got, want in _run({"flatten": True, "dims": (1,), "output_mode": "noise_x_ratios",
                           "iterations": 2}, shape=(1, 2, 3, 8, 8), children=True):
        _hold(got, want)


def test_chain_is_bit_equal_on_one_seed_array():
    """The recurrence alone, on one seed array of the default range: the
    values, adds and muls of every step against the JAX scan's."""
    noise = (np.random.default_rng(3).random((2, 64, 64), np.float32) * 16001.0
             - 8000.0).astype(np.float32)
    jg, tg = JC.CollatzGenerator(), TC.CollatzGenerator()
    want = [np.asarray(a) for a in jg._chain_scan(jnp.asarray(noise), 8)]
    got = [a.numpy() for a in tg._chain(torch.from_numpy(noise), 8)]
    assert float(np.abs(want[0]).max()) > 2**22  # values near float32's integer limit
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_bad_parameters_raise():
    ctx = NoiseCtx(SHAPE, device="cpu")
    with pytest.raises(ValueError, match="Dimension out of range"):
        TC.CollatzGenerator(dims=(4,)).generate(ctx, {}, 0, 1.0, 0.5)
    with pytest.raises(ValueError, match="Bad output mode"):
        TC.CollatzGenerator(output_mode="nope").generate(ctx, {"seed": None, "mix": None}, 0,
                                                         1.0, 0.5)
    p, j = TC.CollatzGenerator.ng_params(), JC.CollatzGenerator.ng_params()
    assert p.pop("noise_dtype") == torch.float32 and j.pop("noise_dtype") == jnp.float32
    assert p == j
