"""The port's distribution-zoo generator (``noise/distro.py``) against the
JAX package's, on the CPU.

- The tables (``DISTRO_PARAMS``, ``_EVENT_DIMS``, ``_SIMPLE``, the
  parameter name sets), ``build_params``, ``ng_params`` and
  ``_parse_param``: equal.
- ``result_index`` trimming and quantile normalization on one shared raw
  array (the sampler entry swapped on both sides): 1e-6 relative to
  max(1, |JAX|), float32 sorts and sums in the same order.
- Every sampler that is a transform of uniforms or normals, on one shared
  numpy stream (the JAX module's ``jax.random`` and the port's Philox draws
  replaced by one table read in call order; the stand-ins apply
  ``jax.random``'s own formulas, checked against ``jax.random`` on a key):
  each raw element within 1e-5 of max(1, |JAX|) relative to itself.
- Every distribution by statistics at 2¹⁶ draws of the port's own Philox
  stream: a KS test against ``scipy.stats`` (p > 1e-3) where a CDF exists,
  else the mean and variance within 5 standard errors.
- The rejection samplers' fixed rounds: the acceptance of a round measured
  on 2¹⁶ draws, every element accepted, and the miss bound it implies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import sonar_tpu.core.rng as JR
import sonar_tpu.noise.distro as JD
import sonar_tpu_torch.core.rng as TR
import sonar_tpu_torch.noise.distro as TD
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu_torch.noise import NoiseCtx

SHAPE = (1, 4, 16, 16)
N_STATS = 1 << 16
STATS_CTX = NoiseCtx((1, 1, 256, 256), device="cpu")
F32 = np.float32


def test_tables_equal_jax():
    assert list(TD.DISTRO_PARAMS) == list(JD.DISTRO_PARAMS)
    assert len(TD.DISTRO_PARAMS) == 26
    for k, (_, pd) in TD.DISTRO_PARAMS.items():
        assert pd == JD.DISTRO_PARAMS[k][1], k
    assert TD._EVENT_DIMS == JD._EVENT_DIMS and TD._SIMPLE == JD._SIMPLE
    assert TD._SCALAR_PARAMS == JD._SCALAR_PARAMS
    assert TD._VECTOR_EXPECTED == JD._VECTOR_EXPECTED
    assert TD.build_params() == JD.build_params()
    assert TD.DistroGenerator.ng_params() == JD.DistroGenerator.ng_params()
    assert TD.DistroGenerator.name == JD.DistroGenerator.name


@pytest.mark.parametrize("name,val", [
    *JD.build_params().items(),
    ("concentration", "0.1 0.2 0.3"), ("df1", "3.0 4.0"), ("p", "0.5 0.7"),
    ("loc", [1, 2]), ("rate", (2.5,)), ("std", 3.0), ("dim", 4), ("mean", "1.5"),
])
def test_parse_param_equals_jax(name, val):
    pname = name.split("_", 1)[1] if name in JD.build_params() else name
    for key in {pname, name.rsplit("_", 1)[-1]}:
        want, got = JD._parse_param(key, val), TD._parse_param(key, val)
        if isinstance(want, jax.Array):
            assert isinstance(got, np.ndarray) and got.dtype == np.float32
            assert np.array_equal(got, np.asarray(want))
        else:
            assert not isinstance(got, np.ndarray) and got == want


# ---------------------------------------------------------------------------
# trimming and normalization on one raw array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distro,kw", [
    ("gamma", {"gamma_concentration": "1.0 2.0 3.0"}),
    ("gamma", {"gamma_concentration": "1.0 2.0 3.0", "result_index": "0 1"}),
    ("gamma", {"gamma_concentration": "1.0 2.0 3.0", "result_index": "7"}),
    ("gamma", {"gamma_concentration": "1.0 2.0 3.0", "result_index": "-9"}),
    ("lkjcholesky", {"result_index": "0 -1"}),
    ("lkjcholesky", {"result_index": (1,)}),
    ("wishart", {"result_index": 1, "quantile_norm_flatten": False}),
    ("dirichlet", {"quantile_norm_dim": 2, "quantile_norm_pow": 1.0}),
    ("normal", {"quantile_norm": 0.6, "quantile_norm_fac": 1.3}),
    ("mvariate_normal", {"quantile_norm": 1.0}),
    ("cauchy", {"cauchy_median": "0.0 1.0"}),  # simple: no trailing dim
])
def test_trim_and_quantile_normalize_equal_jax(distro, kw, monkeypatch):
    raws, shapes = {}, []

    def table(shape):
        shapes.append(tuple(shape))
        if tuple(shape) not in raws:
            rng = np.random.default_rng(len(raws) + 1)
            raws[tuple(shape)] = (rng.standard_normal(shape) * 2.0 + 0.3).astype(F32)
        return raws[tuple(shape)]

    pdef = JD.DISTRO_PARAMS[distro][1]
    monkeypatch.setitem(JD.DISTRO_PARAMS, distro,
                        (lambda key, p, shape, dtype: jnp.asarray(table(shape)), pdef))
    monkeypatch.setitem(TD.DISTRO_PARAMS, distro,
                        (lambda seed, p, shape, dtype, device: torch.from_numpy(table(shape)),
                         pdef))
    want, _ = JD.DistroGenerator(distro=distro, **kw).generate(
        JCtx(SHAPE), (), jax.random.key(0), 1.0, 0.5)
    got, _ = TD.DistroGenerator(distro=distro, **kw).generate(
        NoiseCtx(SHAPE, device="cpu"), (), 0, 1.0, 0.5)
    assert shapes[0] == shapes[1]
    want = np.asarray(want)
    assert got.shape == want.shape == SHAPE
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= 1e-6 * max(1.0, float(np.abs(want).max())), err


def test_bad_distro_and_result_index():
    with pytest.raises(ValueError, match="Bad distro"):
        TD.DistroGenerator(distro="nope").generate(NoiseCtx(SHAPE, device="cpu"), (), 0, 1, 0)
    with pytest.raises(ValueError, match="must not be empty"):
        TD.DistroGenerator(result_index=()).generate(NoiseCtx(SHAPE, device="cpu"), (), 0, 1, 0)


# ---------------------------------------------------------------------------
# the transforms, on one shared stream of uniforms and normals
# ---------------------------------------------------------------------------


class _Stream:
    """Uniforms in [0, 1) on a 2⁻²³ grid and normals, handed out in call
    order to each side."""

    def __init__(self):
        rng = np.random.default_rng(11)
        self.u = (np.floor(rng.random(400_000) * 2**23) / 2**23).astype(F32)
        self.z = rng.standard_normal(400_000).astype(F32)
        self.pos = {("u", "jax"): 0, ("u", "torch"): 0, ("z", "jax"): 0, ("z", "torch"): 0}

    def take(self, kind, side, shape):
        n = int(np.prod(shape))
        p = self.pos[(kind, side)]
        self.pos[(kind, side)] = p + n
        return getattr(self, kind)[p:p + n].reshape(tuple(shape))


def _j_uniform(u, minval, maxval, dtype=jnp.float32):
    """``jax.random.uniform``'s arithmetic on given [0, 1) values; XLA's CPU
    backend fuses ``u·(hi − lo) + lo`` into one multiply-add, computed here
    in float64 and rounded once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = (np.asarray(u, np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return jnp.asarray(np.maximum(lo, fused), dtype)


class _FakeRandom:
    """``jax.random`` reading the stream; the transforms are jax.random's own
    (``test_stand_ins_are_jax_random``)."""

    def __init__(self, st):
        self.st = st

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def split(self, key, num=2):
        return [key] * num

    def fold_in(self, key, data):
        return key

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return _j_uniform(self.st.take("u", "jax", shape), minval, maxval, dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.st.take("z", "jax", shape), dtype)

    def cauchy(self, key, shape=(), dtype=jnp.float32):
        u = self.uniform(key, shape, dtype, jnp.finfo(dtype).eps, 1.0)
        return jnp.tan(jnp.asarray(np.pi, dtype) * (u - jnp.asarray(0.5, dtype)))

    def exponential(self, key, shape=(), dtype=jnp.float32):
        return -jnp.log1p(-self.uniform(key, shape, dtype))

    def gumbel(self, key, shape=(), dtype=jnp.float32):
        return -jnp.log(-jnp.log(self.uniform(key, shape, dtype, jnp.finfo(dtype).tiny, 1.0)))

    def laplace(self, key, shape=(), dtype=jnp.float32):
        u = self.uniform(key, shape, dtype, -1.0 + jnp.finfo(dtype).epsneg, 1.0)
        return jnp.sign(u) * jnp.log1p(-jnp.abs(u))


def test_stand_ins_are_jax_random():
    """Each stand-in transform, fed ``jax.random.uniform``'s draw of a key,
    gives ``jax.random``'s own draw of that key bit for bit."""
    key, shape = jax.random.key(3), (4096,)
    fake = _FakeRandom(None)
    tiny, eps = jnp.finfo(jnp.float32).tiny, jnp.finfo(jnp.float32).eps
    for name, lo in (("cauchy", eps), ("exponential", 0.0), ("gumbel", tiny),
                     ("laplace", -1.0 + jnp.finfo(jnp.float32).epsneg)):
        u = jax.random.uniform(key, shape, jnp.float32, lo, 1.0)
        fake.uniform = lambda k, s=(), d=jnp.float32, minval=0.0, maxval=1.0, _u=u: _u
        want = getattr(jax.random, name)(key, shape, jnp.float32)
        assert np.array_equal(np.asarray(getattr(fake, name)(key, shape)), np.asarray(want)), name
    unit = (jax.random.uniform(key, shape) * 2**23).astype(jnp.int32) / 2**23
    assert np.array_equal(np.asarray(_j_uniform(unit, 0.2, 0.9)),
                          np.asarray(jax.random.uniform(key, shape, jnp.float32, 0.2, 0.9)))


@pytest.fixture
def stream(monkeypatch):
    st = _Stream()
    fake = type("FakeJax", (), {"random": _FakeRandom(st),
                                "__getattr__": lambda self, n: getattr(jax, n)})()
    monkeypatch.setattr(JD, "jax", fake)
    monkeypatch.setattr(JR, "jax", fake)

    def rand(seed, shape, *, device, dtype=torch.float32, stream=0):
        return torch.from_numpy(st.take("u", "torch", shape).copy()).to(device=device,
                                                                         dtype=dtype)

    def randn(seed, shape, *, device, dtype=torch.float32, stream=0):
        return torch.from_numpy(st.take("z", "torch", shape).copy()).to(device=device,
                                                                         dtype=dtype)

    for mod in (TD, TR):
        monkeypatch.setattr(mod, "philox_rand", rand)
    monkeypatch.setattr(TD, "philox_randn", randn)
    return st


def _jax_raw(gen, shape):
    """The JAX generator's draw before trimming (its ``generate``'s first
    half)."""
    fn, pdef = JD.DISTRO_PARAMS[gen.distro]
    params = {k: JD._parse_param(k, getattr(gen, f"{gen.distro}_{k}")) for k in pdef}
    if JD._EVENT_DIMS.get(gen.distro, 0) == 0 and gen.distro not in JD._SIMPLE:
        klen = max((v.shape[0] for v in params.values()
                    if isinstance(v, jax.Array) and v.ndim), default=1)
        if klen > 1:
            shape = shape + (klen,)
    return np.asarray(fn(jax.random.key(0), params, shape, jnp.float32))


TRANSFORMS = [
    ("cauchy", {}), ("cauchy", {"cauchy_median": "1.0", "cauchy_sigma": 0.5}),
    ("exponential", {"exponential_lambd": 2.5}), ("geometric", {}),
    ("log_normal", {}), ("normal", {"normal_mean": 0.5, "normal_std": 2.0}),
    ("continuous_bernoulli", {}), ("continuous_bernoulli", {"continuous_bernoulli_probs": "0.3"}),
    ("continuous_bernoulli", {"continuous_bernoulli_probs": "0.2 0.5 0.8"}),
    ("gumbel", {}), ("kumaraswamy", {"kumaraswamy_concentration0": "3.0",
                                     "kumaraswamy_concentration1": "2.0"}),
    ("laplacian", {"laplacian_loc": "0.5 -0.5"}), ("lrmvariate_normal", {}),
    ("lrmvariate_normal", {"lrmvariate_normal_cov_factor": "1.0 0.5 0.2 0.1"}),
    ("mvariate_normal", {"mvariate_normal_cov_multiplier": 2.0}), ("pareto", {}),
    ("relaxed_bernoulli", {}), ("relaxed_onehotcategorical", {}),
    ("relaxed_onehotcategorical", {"relaxed_onehotcategorical_probs": "0.2 0.3 0.5"}),
    ("studentt", {}), ("studentt", {"studentt_df": "3.0", "studentt_scale": "2.0"}),
    ("uniform", {"uniform_low": -1.0, "uniform_high": 2.0}), ("weibull", {}),
    ("weibull", {"weibull_concentration": "2.0 0.5"}),
]


@pytest.mark.parametrize("distro,kw", TRANSFORMS)
def test_transform_samplers_equal_jax_on_shared_draws(distro, kw, stream):
    want = _jax_raw(JD.DistroGenerator(distro=distro, **kw), SHAPE)
    got = TD.DistroGenerator(distro=distro, **kw).raw(NoiseCtx(SHAPE, device="cpu"), 0).numpy()
    assert stream.pos[("u", "jax")] == stream.pos[("u", "torch")]
    assert stream.pos[("z", "jax")] == stream.pos[("z", "torch")]
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max()) <= 1e-5, float(err.max())


def test_every_distribution_is_held_somewhere():
    transforms = {d for d, _ in TRANSFORMS}
    assert transforms | TD.REJECTION == set(TD.DISTRO_PARAMS)
    assert not transforms & TD.REJECTION


# ---------------------------------------------------------------------------
# statistics of the port's own stream
# ---------------------------------------------------------------------------


def _raw(distro, seed=5, **kw):
    return TD.DistroGenerator(distro=distro, **kw).raw(STATS_CTX, seed).numpy().astype(
        np.float64)


def _ks(x, cdf, args=()):
    # a scipy.stats name becomes its frozen distribution's CDF (some scipy
    # versions hand a name's args to a ufunc that takes none)
    cdf = getattr(stats, cdf)(*args).cdf if isinstance(cdf, str) else cdf
    p = stats.kstest(np.ravel(x), cdf).pvalue
    assert p > 1e-3, p


def _moments(x, mean, var):
    x = np.ravel(x)
    se_m, se_v = np.sqrt(var / x.size), var * np.sqrt(2.0 / x.size) * 2
    assert abs(x.mean() - mean) <= 5 * se_m, (x.mean(), mean)
    assert abs(x.var() - var) <= 5 * se_v, (x.var(), var)


def _relaxed_cdf(logit, temp):
    def cdf(x):
        with np.errstate(divide="ignore"):
            return 1.0 / (1.0 + np.exp(-(temp * np.log(x / (1.0 - x)) - logit)))
    return cdf


STATS = {
    "exponential": lambda: _ks(_raw("exponential"), "expon"),
    "cauchy": lambda: _ks(_raw("cauchy"), "cauchy"),
    "geometric": lambda: _moments(_raw("geometric"), 4.0, 12.0),
    "log_normal": lambda: _ks(_raw("log_normal"), "lognorm", (2.0, 0.0, np.e)),
    "normal": lambda: _ks(_raw("normal"), "norm"),
    "beta": lambda: (_ks(_raw("beta"), "beta", (0.5, 0.5)),
                     _ks(_raw("beta", beta_concentration1="2.0", beta_concentration0="5.0"),
                         "beta", (2.0, 5.0))),
    "continuous_bernoulli": lambda: (
        _ks(_raw("continuous_bernoulli"), "uniform"),
        _ks(_raw("continuous_bernoulli", continuous_bernoulli_probs="0.3"),
            lambda x: (0.3**x * 0.7 ** (1 - x) - 0.7) / (0.6 - 1.0))),
    "dirichlet": lambda: (_ks(_raw("dirichlet")[..., 0], "beta", (0.5, 0.5)),
                          np.testing.assert_allclose(_raw("dirichlet").sum(-1), 1.0, atol=1e-5)),
    "fisher_snedecor": lambda: _ks(_raw("fisher_snedecor"), "f", (1.0, 2.0)),
    "gamma": lambda: (_ks(_raw("gamma"), "gamma", (1.0,)),
                      _ks(_raw("gamma", gamma_concentration="0.3", gamma_rate="2.0"), "gamma",
                          (0.3, 0.0, 0.5)),
                      _ks(_raw("gamma", gamma_concentration="40.0"), "gamma", (40.0,))),
    "gumbel": lambda: _ks(_raw("gumbel"), "gumbel_r", (1.0, 2.0)),
    "inverse_gamma": lambda: _ks(_raw("inverse_gamma"), "invgamma", (1.0,)),
    "kumaraswamy": lambda: _ks(_raw("kumaraswamy", kumaraswamy_concentration1="2.0",
                                    kumaraswamy_concentration0="3.0"),
                               lambda x: 1.0 - (1.0 - x**2.0) ** 3.0),
    "laplacian": lambda: _ks(_raw("laplacian"), "laplace"),
    # LKJ(η = 1) in dim 3: each correlation r has (r + 1)/2 ~ Beta(1.5, 1.5)
    "lkjcholesky": lambda: (lambda L: (
        np.testing.assert_allclose((L**2).sum(-1), 1.0, atol=1e-5),
        _ks(((L[..., 1, :] * L[..., 2, :]).sum(-1) + 1.0) / 2.0, "beta", (1.5, 1.5))))(
        _raw("lkjcholesky")),
    "lrmvariate_normal": lambda: (lambda z: (_ks(z[..., 0], "norm", (0.0, np.sqrt(2.0))),
                                             _ks(z[..., 1], "norm")))(_raw("lrmvariate_normal")),
    "mvariate_normal": lambda: _ks(_raw("mvariate_normal"), "norm"),
    "pareto": lambda: _ks(_raw("pareto"), "pareto", (1.0,)),
    "poisson": lambda: (_moments(_raw("poisson"), 1.5, 1.5),
                        _moments(_raw("poisson", poisson_rate="9.5"), 9.5, 9.5),
                        _moments(_raw("poisson", poisson_rate="10.0"), 10.0, 10.0),
                        _moments(_raw("poisson", poisson_rate="250.0"), 250.0, 250.0),
                        _moments(_raw("poisson", poisson_rate="3.0 30.0")[..., 1], 30.0, 30.0)),
    "relaxed_bernoulli": lambda: _ks(_raw("relaxed_bernoulli"),
                                     _relaxed_cdf(np.log(0.66 / 0.34), 0.75)),
    "relaxed_onehotcategorical": lambda: _ks(_raw("relaxed_onehotcategorical")[..., 1],
                                             _relaxed_cdf(np.log(0.66 / 0.33), 1.5)),
    "studentt": lambda: _ks(_raw("studentt"), "t", (1.0,)),
    "uniform": lambda: _ks(_raw("uniform"), "uniform"),
    "vonmises": lambda: (_ks(_raw("vonmises"), "vonmises", (1.0, 1.0)),
                         _ks(_raw("vonmises", vonmises_concentration="8.0"), "vonmises",
                             (8.0, 1.0))),
    "weibull": lambda: _ks(_raw("weibull", weibull_concentration="2.0"), "weibull_min", (2.0,)),
    "wishart": lambda: (lambda W: (_ks(W[..., 0, 0], "chi2", (2.0,)),
                                   _moments(W[..., 0, 1], 0.0, 2.0)))(_raw("wishart")),
}


@pytest.mark.parametrize("distro", list(JD.DISTRO_PARAMS))
def test_distribution_statistics(distro):
    STATS[distro]()


# ---------------------------------------------------------------------------
# the fixed rounds of the rejection samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distro,kw,first_round,rounds", [
    ("gamma", {}, 0.94, TD.GAMMA_ROUNDS),  # α = 1: the boost's worst case too (α + 1 ≥ 1)
    ("gamma", {"gamma_concentration": "0.05"}, 0.94, TD.GAMMA_ROUNDS),
    ("poisson", {"poisson_rate": "10.0"}, 0.70, TD.POISSON_ROUNDS),  # PTRS' worst rate
    ("vonmises", {"vonmises_concentration": "1.0"}, 0.65, TD.VONMISES_ROUNDS),
])
def test_rejection_rounds_accept(distro, kw, first_round, rounds, monkeypatch):
    """The share of proposals a round accepts, on 2¹⁶ draws: a miss of all
    rounds has probability (1 − share)^rounds, below 1e-10 for each."""
    seen = []
    pick = TD._pick_first

    def record(accept, values, miss):
        seen.append(accept)
        return pick(accept, values, miss)

    monkeypatch.setattr(TD, "_pick_first", record)
    _raw(distro, **kw)
    (accept,) = seen
    assert accept.shape[0] == rounds
    share = float(accept.float().mean())
    assert share >= first_round, share
    assert bool(accept.any(0).all())
    assert (1.0 - share) ** rounds < 1e-10
