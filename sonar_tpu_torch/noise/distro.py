"""Distribution-zoo noise generator (port of ``sonar_tpu.noise.distro``;
reference DistroNoiseGenerator, py/noise_generation.py:805-1256).

26 distributions, each a pure function of (seed, params, shape) with static
shapes. Every draw is the Philox stream of :mod:`..kernels.hwrng` (kernel B3
on the card, its plain version on the CPU), so one seed gives the same noise
on both devices; sub-streams come from
:func:`~sonar_tpu_torch.core.rng.derive_seed`. torch's own samplers
(``torch._standard_gamma``, ``torch.poisson``, ``Tensor.cauchy_`` and the
rest) take a ``torch.Generator``, whose stream differs between the CPU and
the card, and are not used.

- Uniform transforms (Cauchy, exponential, Gumbel, geometric, Kumaraswamy,
  Pareto, ...) apply ``jax.random``'s formulas to Philox uniforms; normals
  are Philox normals; Laplace and Student-t are :mod:`..core.rng`'s.
- Gamma is Marsaglia–Tsang (2000) with the ``α < 1`` boost
  (``G(α+1)·U^{1/α}``), in log space (beta and Dirichlet take ratios of
  gammas there, as ``jax.random`` does). All :data:`GAMMA_ROUNDS` proposals
  are drawn at once and the first accepted one is kept by mask-select: the
  acceptance probability of a round is at least 0.95 for ``α + 1 ≥ 1``
  (Marsaglia and Tsang's bound), so 8 rounds leave a miss below
  0.05⁸ ≈ 4e-11 an element; a miss takes the mode, ``d``.
- Poisson is inversion of the CDF below rate 10 (40 terms: the tail past
  them is below 1e-12 at rate 10) and Hörmann's transformed rejection (PTRS)
  from 10 on, :data:`POISSON_ROUNDS` rounds (a round accepts 75 % at rate
  10, more above it: a miss below 0.3²⁴ ≈ 3e-13; a miss takes the rounded
  rate).
- von Mises is Best–Fisher rejection with 16 rounds, as in the JAX package.

No round reads a value back to the host: a draw is a fixed sequence of
launches. Parameters are host numbers; a vector parameter of ``k > 1``
values becomes a ``(k,)`` tensor made by ``k`` fills on the device (no copy
from the host), broadcast into a trailing dim that ``result_index`` cycling
trims (py/noise_generation.py:1177-1196). The output goes through
:func:`~sonar_tpu_torch.core.normalize.quantile_normalize` (q 0.85, dim 1,
flatten, pow 0.5; py/noise_generation.py:1197-1215). Draws compute in
float32 for bfloat16 and float16 contexts and are rounded once at the end.
"""

from __future__ import annotations

import contextvars
import math
from typing import Callable

import numpy as np
import torch

from ..core.normalize import quantile_normalize
from ..core.rng import derive_seed, draw_laplace, draw_t
from ..kernels.hwrng import philox_rand, philox_randn
from ..utils.misc import default_device, work_dtype
from .base import NoiseCtx, quantile_dims
from .generators import Generator

GAMMA_ROUNDS = 8
POISSON_ROUNDS = 24
POISSON_TERMS = 40  # inversion below rate 10
VONMISES_ROUNDS = 16

_F32 = np.float32

# ---------------------------------------------------------------------------
# draws and parameters
# ---------------------------------------------------------------------------


# the ctx of the draw in progress: on a shard, every draw below is this
# rank's slice of the whole latent's (an unsharded ctx outside a draw)
_CTX: contextvars.ContextVar = contextvars.ContextVar("distro_ctx", default=NoiseCtx(shape=()))


def _sliced(fn, seed, shape, lead=0, **kw):
    """``fn(seed, shape, **kw)`` through the draw's ctx (``NoiseCtx.draw``)."""
    return _CTX.get().draw(lambda s, sh, **k: fn(s, sh, **kw, **k), seed, shape, lead=lead)


def _rand(seed, shape, dtype, device, lead=0):
    return _sliced(philox_rand, seed, shape, lead, device=device, dtype=dtype)


def _uniform(seed, shape, dtype, device, lo, hi):
    """``jax.random.uniform``'s arithmetic on Philox uniforms u in [0, 1):
    ``max(lo, u·(hi − lo) + lo)`` in the draw's type."""
    lo, hi = _F32(lo), _F32(hi)
    u = _rand(seed, shape, dtype, device)
    return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))


def _u(seed, shape, dtype, device):
    return _uniform(seed, shape, dtype, device, 1e-7, 1.0 - 1e-7)


def _normal(seed, shape, dtype, device, lead=0):
    return _sliced(philox_randn, seed, shape, lead, device=device, dtype=dtype)


def _exp1(seed, shape, dtype, device):
    """``jax.random.exponential``: −log1p(−u)."""
    return -torch.log1p(-_rand(seed, shape, dtype, device))


def _gumbel1(seed, shape, dtype, device):
    """``jax.random.gumbel``: −log(−log(u)), u in [tiny, 1)."""
    u = _uniform(seed, shape, dtype, device, np.finfo(np.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def _arg(v, device, dtype):
    """A parameter as the arithmetic takes it: a number, or for a vector of
    k > 1 values a (k,) tensor filled on the device value by value."""
    a = np.asarray(v, np.float32).reshape(-1)
    if a.size == 1:
        return float(a[0])
    return torch.cat([torch.full((1,), float(x), device=device, dtype=dtype) for x in a])


def _tensor(v, device, dtype):
    """A parameter as a tensor: 0-dim for one value, (k,) for k; a tensor
    passes through."""
    if isinstance(v, torch.Tensor):
        return v
    a = _arg(v, device, dtype)
    return torch.full((), a, device=device, dtype=dtype) if isinstance(a, float) else a


def _first(v) -> float:
    return float(np.asarray(v, np.float32).reshape(-1)[0])


def _pick_first(accept: torch.Tensor, values: torch.Tensor, miss) -> torch.Tensor:
    """Mask-select over the rounds (dim 0): each element takes its first
    accepted round's value, ``miss`` where no round accepted."""
    out = miss
    for r in range(accept.shape[0] - 1, -1, -1):
        out = torch.where(accept[r], values[r], out)
    return out


def _log_gamma(seed, alpha, shape, dtype, device):
    """log of Gamma(α, 1) draws (Marsaglia–Tsang with the α < 1 boost, all
    rounds drawn at once; see the module docstring)."""
    alpha = _tensor(alpha, device, dtype)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    shape = tuple(shape)
    x = _normal(derive_seed(seed, 0), (GAMMA_ROUNDS,) + shape, dtype, device, lead=1)
    u = 1.0 - _rand(derive_seed(seed, 1), (GAMMA_ROUNDS + 1,) + shape, dtype, device,
                    lead=1)  # (0, 1]
    v = (1.0 + c * x) ** 3
    ok = v > 0
    logv = torch.log(torch.where(ok, v, 1.0))
    accept = ok & (torch.log(u[:GAMMA_ROUNDS]) < 0.5 * x * x + d - d * v + d * logv)
    log_d = torch.log(d).expand(shape)
    out = log_d + _pick_first(accept, logv, torch.zeros_like(log_d))
    return out + torch.where(boost, torch.log(u[GAMMA_ROUNDS]) / alpha, 0.0)


def _gamma_draw(seed, alpha, shape, dtype, device):
    return torch.exp(_log_gamma(seed, alpha, shape, dtype, device))


def _beta_draw(seed, a, b, shape, dtype, device):
    """``jax.random.beta``'s ratio of gammas, in log space."""
    la = _log_gamma(derive_seed(seed, 0), a, shape, dtype, device)
    lb = _log_gamma(derive_seed(seed, 1), b, shape, dtype, device)
    m = torch.maximum(la, lb)
    ga, gb = torch.exp(la - m), torch.exp(lb - m)
    return ga / (ga + gb)


def _poisson_inversion(u, rate, dtype):
    """Inversion of the CDF at ``rate`` (a tensor, < 10): the count of CDF
    terms below u, in float64."""
    j = torch.arange(POISSON_TERMS, device=u.device, dtype=torch.float64)
    lam = rate.to(torch.float64).unsqueeze(-1)
    cdf = torch.cumsum(torch.exp(torch.xlogy(j, lam) - lam - torch.lgamma(j + 1.0)), dim=-1)
    return (u.to(torch.float64).unsqueeze(-1) > cdf).sum(-1).to(dtype)


def _poisson_ptrs(seed, rate, shape, dtype, device):
    """Hörmann's PTRS (1993) for rate ≥ 10, all rounds at once."""
    slam = torch.sqrt(rate)
    loglam = torch.log(rate)
    b = 0.931 + 2.53 * slam
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    vr = 0.9277 - 3.6224 / (b - 2.0)
    uv = _rand(seed, (2, POISSON_ROUNDS) + tuple(shape), dtype, device, lead=2)
    U, V = uv[0] - 0.5, uv[1]
    us = 0.5 - torch.abs(U)
    k = torch.floor((2.0 * a / us + b) * U + rate + 0.43)
    fast = (us >= 0.07) & (V <= vr)
    bad = (k < 0) | ((us < 0.013) & (V > us))
    slow = torch.log(V) + torch.log(inv_alpha) - torch.log(a / (us * us) + b) <= (
        -rate + k * loglam - torch.lgamma(k + 1.0))
    accept = fast | (~bad & slow)
    miss = torch.round(rate).expand(tuple(shape))
    return _pick_first(accept, k, miss)


def _poisson_draw(seed, rate, shape, dtype, device):
    host = np.asarray(rate, np.float32).reshape(-1)
    lam = _tensor(rate, device, dtype)
    small = small_out = None
    if (host < 10).any():
        u = _rand(derive_seed(seed, 0), shape, dtype, device)
        small_out = _poisson_inversion(u, torch.clamp(lam, max=10.0), dtype)
        small = lam < 10.0
    if (host >= 10).all():
        return _poisson_ptrs(derive_seed(seed, 1), lam, shape, dtype, device)
    if (host < 10).all():
        return small_out
    big = _poisson_ptrs(derive_seed(seed, 1), torch.clamp(lam, min=10.0), shape, dtype, device)
    return torch.where(small, small_out, big)


# ---------------------------------------------------------------------------
# per-distribution samplers: fn(seed, params, shape, dtype, device) -> tensor
# params are numbers or float32 numpy vectors (:func:`_parse_param`)
# ---------------------------------------------------------------------------


def _cauchy(seed, p, shape, dtype, device):
    u = _uniform(seed, shape, dtype, device, np.finfo(np.float32).eps, 1.0)
    c = torch.tan(float(_F32(np.pi)) * (u - 0.5))
    return _arg(p["median"], device, dtype) + _arg(p["sigma"], device, dtype) * c


def _exponential(seed, p, shape, dtype, device):
    return _exp1(seed, shape, dtype, device) / _arg(p["lambd"], device, dtype)


def _geometric(seed, p, shape, dtype, device):
    # torch.Tensor.geometric_: k ∈ {1, 2, ...}, P(k) = (1-p)^(k-1) p
    u = _u(seed, shape, dtype, device)
    return torch.floor(torch.log(u) / torch.log1p(-_tensor(p["p"], device, dtype))) + 1.0


def _log_normal(seed, p, shape, dtype, device):
    z = _normal(seed, shape, dtype, device)
    return torch.exp(_arg(p["mean"], device, dtype) + _arg(p["std"], device, dtype) * z)


def _normal_d(seed, p, shape, dtype, device):
    z = _normal(seed, shape, dtype, device)
    return _arg(p["mean"], device, dtype) + _arg(p["std"], device, dtype) * z


def _beta(seed, p, shape, dtype, device):
    # torch Beta(concentration1=a, concentration0=b): pdf ∝ x^(a-1)(1-x)^(b-1)
    return _beta_draw(seed, p["concentration1"], p["concentration0"], shape, dtype, device)


def _continuous_bernoulli(seed, p, shape, dtype, device):
    lam = _tensor(p["probs"], device, dtype)
    u = _u(seed, shape, dtype, device)
    near_half = torch.abs(lam - 0.5) < 1e-4
    lam_safe = torch.where(near_half, 0.4, lam)
    x = (torch.log1p(u * (2.0 * lam_safe - 1.0) / (1.0 - lam_safe))
         / torch.log(lam_safe / (1.0 - lam_safe)))
    return torch.where(near_half, u, x)


def _dirichlet(seed, p, shape, dtype, device):
    conc = _tensor(p["concentration"], device, dtype).reshape(-1)
    lg = _log_gamma(seed, conc, tuple(shape) + (conc.shape[0],), dtype, device)
    g = torch.exp(lg - torch.amax(lg, dim=-1, keepdim=True))
    return g / g.sum(-1, keepdim=True)


def _fisher_snedecor(seed, p, shape, dtype, device):
    d1, d2 = _arg(p["df1"], device, dtype), _arg(p["df2"], device, dtype)
    g1 = _gamma_draw(derive_seed(seed, 0), d1 / 2.0, shape, dtype, device) * 2.0
    g2 = _gamma_draw(derive_seed(seed, 1), d2 / 2.0, shape, dtype, device) * 2.0
    return (g1 / d1) / torch.clamp(g2 / d2, min=1e-20)


def _gamma(seed, p, shape, dtype, device):
    g = _gamma_draw(seed, p["concentration"], shape, dtype, device)
    return g / _arg(p["rate"], device, dtype)


def _gumbel(seed, p, shape, dtype, device):
    g = _gumbel1(seed, shape, dtype, device)
    return _arg(p["loc"], device, dtype) + _arg(p["scale"], device, dtype) * g


def _inverse_gamma(seed, p, shape, dtype, device):
    g = _gamma_draw(seed, p["concentration"], shape, dtype, device)
    return _arg(p["rate"], device, dtype) / torch.clamp(g, min=1e-20)


def _kumaraswamy(seed, p, shape, dtype, device):
    a, b = _arg(p["concentration1"], device, dtype), _arg(p["concentration0"], device, dtype)
    u = _u(seed, shape, dtype, device)
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def _laplacian(seed, p, shape, dtype, device):
    z = _sliced(draw_laplace, seed, shape, dtype=dtype, device=device)
    return _arg(p["loc"], device, dtype) + _arg(p["scale"], device, dtype) * z


def _lkjcholesky(seed, p, shape, dtype, device):
    """LKJ Cholesky-factor sampling by the onion method. Event shape
    (dim, dim); sample shape (*shape, dim, dim)."""
    dim = int(p["dim"])
    shape = tuple(shape)
    if dim < 2:
        return torch.ones(shape + (1, 1), device=device, dtype=dtype)
    beta_par = _first(p["concentration"]) + (dim - 2) / 2.0
    rows = [torch.nn.functional.pad(torch.ones(shape + (1,), device=device, dtype=dtype),
                                    (0, dim - 1))]
    for i in range(1, dim):
        y = _beta_draw(derive_seed(seed, "b", i), i / 2.0, beta_par - (i - 1) / 2.0, shape,
                       dtype, device)
        v = _normal(derive_seed(seed, "n", i), shape + (i,), dtype, device)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        row = torch.cat([torch.sqrt(y)[..., None] * v, torch.sqrt(1.0 - y)[..., None]], dim=-1)
        rows.append(torch.nn.functional.pad(row, (0, dim - 1 - i)))
    return torch.stack(rows, dim=-2)


def _lrmvariate_normal(seed, p, shape, dtype, device):
    loc = _tensor(p["loc"], device, dtype).reshape(-1)
    k = loc.shape[0]
    cov_factor = _tensor(p["cov_factor"], device, dtype).reshape(k, -1)
    cov_diag = _tensor(p["cov_diag"], device, dtype)
    r = cov_factor.shape[1]
    z1 = _normal(derive_seed(seed, 0), tuple(shape) + (r,), dtype, device)
    z2 = _normal(derive_seed(seed, 1), tuple(shape) + (k,), dtype, device)
    # "...r,kr->...k" as a product-sum: exact float32 whatever the TF32 switches
    return loc + (z1.unsqueeze(-2) * cov_factor).sum(-1) + torch.sqrt(cov_diag) * z2


def _mvariate_normal(seed, p, shape, dtype, device):
    loc = _tensor(p["loc"], device, dtype).reshape(-1)
    z = _normal(seed, tuple(shape) + (loc.shape[0],), dtype, device)
    return loc + math.sqrt(float(p["cov_multiplier"])) * z


def _pareto(seed, p, shape, dtype, device):
    u = _u(seed, shape, dtype, device)
    return _arg(p["scale"], device, dtype) / u ** (1.0 / _arg(p["alpha"], device, dtype))


def _poisson(seed, p, shape, dtype, device):
    return _poisson_draw(seed, p["rate"], shape, dtype, device)


def _relaxed_bernoulli(seed, p, shape, dtype, device):
    probs = _tensor(p["probs"], device, dtype)
    u = _u(seed, shape, dtype, device)
    logistic = torch.log(u) - torch.log1p(-u)
    logits = torch.log(probs) - torch.log1p(-probs)
    return torch.sigmoid((logits + logistic) / _arg(p["temperature"], device, dtype))


def _relaxed_onehotcategorical(seed, p, shape, dtype, device):
    probs = _tensor(p["probs"], device, dtype).reshape(-1)
    g = _gumbel1(seed, tuple(shape) + (probs.shape[0],), dtype, device)
    return torch.softmax((torch.log(probs) + g) / _arg(p["temperature"], device, dtype), dim=-1)


def _studentt(seed, p, shape, dtype, device):
    df = np.asarray(p["df"], np.float32).reshape(-1)
    if df.size == 1:
        t = _sliced(lambda s, sh, **k: draw_t(s, float(df[0]), sh, dtype, **k), seed, shape,
                    device=device)
    else:  # one df a slice of the trailing dim
        t = torch.stack([_sliced(lambda s, sh, v=v, **k: draw_t(s, float(v), sh, dtype, **k),
                                 derive_seed(seed, j), tuple(shape)[:-1], device=device)
                         for j, v in enumerate(df)], dim=-1)
    return _arg(p["loc"], device, dtype) + _arg(p["scale"], device, dtype) * t


def _uniform_d(seed, p, shape, dtype, device):
    lo, hi = _first(p["low"]), _first(p["high"])
    return _uniform(seed, shape, dtype, device, lo, hi)


def _vonmises(seed, p, shape, dtype, device):
    """Best–Fisher (1979) rejection with a fixed round count, all rounds at
    once; a miss takes the last proposal."""
    kappa = torch.clamp(_tensor(p["concentration"], device, dtype), min=1e-6)
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa**2)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
    rpar = (1.0 + rho**2) / (2.0 * rho)
    u = _u(seed, (3, VONMISES_ROUNDS) + tuple(shape), dtype, device)
    u1, u2, u3 = u[0], u[1], u[2]
    z = torch.cos(float(_F32(np.pi)) * u1)
    f = (1.0 + rpar * z) / (rpar + z)
    c = kappa * (rpar - f)
    accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / u2) + 1.0 - c >= 0)
    theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
    return _pick_first(accept, theta, theta[-1]) + _arg(p["loc"], device, dtype)


def _weibull(seed, p, shape, dtype, device):
    e = _exp1(seed, shape, dtype, device)
    return _arg(p["scale"], device, dtype) * e ** (1.0 / _arg(p["concentration"], device, dtype))


def _wishart(seed, p, shape, dtype, device):
    """Bartlett decomposition with covariance = cov_multiplier · I."""
    k = int(p["cov_size"])
    df = _first(p["df"])
    shape = tuple(shape)
    diag = torch.stack([torch.sqrt(2.0 * _gamma_draw(derive_seed(seed, "d", i), (df - i) / 2.0,
                                                     shape, dtype, device))
                        for i in range(k)], dim=-1)
    tril = _normal(derive_seed(seed, "n"), shape + (k, k), dtype, device)
    A = torch.tril(tril, diagonal=-1) + torch.diag_embed(diag)
    # A·Aᵀ as a product-sum: exact float32 whatever the TF32 switches
    W = (A.unsqueeze(-2) * A.unsqueeze(-3)).sum(-1)
    return W * float(p["cov_multiplier"])


_SIMPLE = frozenset(("cauchy", "exponential", "geometric", "log_normal", "normal"))

# (sampler, {param: default}): the JAX package's table (defaults from
# py/noise_generation.py:823-1131; string defaults are vector-capable)
DISTRO_PARAMS: dict[str, tuple[Callable, dict]] = {
    "exponential": (_exponential, {"lambd": 1.0}),
    "cauchy": (_cauchy, {"median": "0.0", "sigma": 1.0}),
    "geometric": (_geometric, {"p": 0.25}),
    "log_normal": (_log_normal, {"mean": 1.0, "std": 2.0}),
    "normal": (_normal_d, {"mean": 0.0, "std": 1.0}),
    "beta": (_beta, {"concentration0": "0.5", "concentration1": "0.5"}),
    "continuous_bernoulli": (_continuous_bernoulli, {"probs": "0.5"}),
    "dirichlet": (_dirichlet, {"concentration": "0.5 0.5"}),
    "fisher_snedecor": (_fisher_snedecor, {"df1": "1.0", "df2": "2.0"}),
    "gamma": (_gamma, {"concentration": "1.0", "rate": "1.0"}),
    "gumbel": (_gumbel, {"loc": "1.0", "scale": "2.0"}),
    "inverse_gamma": (_inverse_gamma, {"concentration": "1.0", "rate": "1.0"}),
    "kumaraswamy": (_kumaraswamy, {"concentration0": "1.0", "concentration1": "1.0"}),
    "laplacian": (_laplacian, {"loc": "0.0", "scale": "1.0"}),
    "lkjcholesky": (_lkjcholesky, {"dim": 3, "concentration": "1.0"}),
    "lrmvariate_normal": (
        _lrmvariate_normal,
        {"loc": "0.0 0.0", "cov_factor": "1.0 0.0", "cov_diag": "1.0 1.0"},
    ),
    "mvariate_normal": (_mvariate_normal, {"loc": "0.0 0.0", "cov_multiplier": 1.0}),
    "pareto": (_pareto, {"scale": "1.0", "alpha": "1.0"}),
    "poisson": (_poisson, {"rate": "1.5"}),
    "relaxed_bernoulli": (_relaxed_bernoulli, {"temperature": 0.75, "probs": "0.66"}),
    "relaxed_onehotcategorical": (
        _relaxed_onehotcategorical,
        {"temperature": 1.5, "probs": "0.33 0.66"},
    ),
    "studentt": (_studentt, {"loc": "0.0", "scale": "1.0", "df": "1.0"}),
    "uniform": (_uniform_d, {"low": 0.0, "high": 1.0}),
    "vonmises": (_vonmises, {"loc": "1.0", "concentration": "1.0"}),
    "weibull": (_weibull, {"scale": "1.0", "concentration": "1.0"}),
    "wishart": (_wishart, {"df": "2.0", "cov_size": 2, "cov_multiplier": 1.0}),
}

# distributions whose raw sample already carries trailing event dims
_EVENT_DIMS = {
    "dirichlet": 1,
    "lrmvariate_normal": 1,
    "mvariate_normal": 1,
    "relaxed_onehotcategorical": 1,
    "lkjcholesky": 2,
    "wishart": 2,
}

# the rejection samplers: a draw is the first accepted of a fixed number of
# rounds (the rest are transforms of one draw)
REJECTION = frozenset(("beta", "dirichlet", "fisher_snedecor", "gamma", "inverse_gamma",
                       "lkjcholesky", "poisson", "vonmises", "wishart"))

_SCALAR_PARAMS = {"dim", "cov_size", "cov_multiplier", "lambd", "p",
                  "temperature", "low", "high", "mean", "std"}
_VECTOR_EXPECTED = {"concentration", "loc", "cov_factor", "cov_diag", "probs"}


def _parse_param(name: str, val):
    """A parameter value: space-separated strings become a float, or a
    float32 vector for the vector-capable names and for several values."""
    if isinstance(val, str):
        parts = tuple(float(v) for v in val.split())
        if name in _SCALAR_PARAMS:
            return parts[0]
        if len(parts) > 1 or name in _VECTOR_EXPECTED:
            return np.asarray(parts, np.float32)
        return parts[0]
    if isinstance(val, (tuple, list)):
        return np.asarray([float(v) for v in val], np.float32)
    return val


def build_params() -> dict:
    """Flat ``{distro}_{param}: default`` map for schema construction
    (py/noise_generation.py:1139-1150)."""
    return {
        f"{dk}_{pk}": pv
        for dk, (_fn, pd) in DISTRO_PARAMS.items()
        for pk, pv in pd.items()
    }


class DistroGenerator(Generator):
    """py/noise_generation.py:805-1256."""

    name = "distro"

    @classmethod
    def ng_params(cls):
        return (
            super().ng_params()
            | {
                "distro": "normal",
                "quantile_norm": 0.85,
                "quantile_norm_flatten": True,
                "quantile_norm_dim": 1,
                "quantile_norm_pow": 0.5,
                "quantile_norm_fac": 1.0,
                "result_index": "-1",
            }
            | build_params()
        )

    def _result_indices(self):
        ri = self.result_index
        if isinstance(ri, str):
            ri = tuple(int(v) for v in ri.split())
        elif not isinstance(ri, (tuple, list)):
            ri = (int(ri),)
        if not ri:
            raise ValueError("When result_index is a list, it must not be empty")
        return tuple(ri)

    def raw(self, ctx, seed):
        """The distribution's draw before trimming and normalization, with
        the trailing dims its vector parameters or event shape give it."""
        distro = self.distro
        if distro not in DISTRO_PARAMS:
            raise ValueError("Bad distro")
        fn, pdef = DISTRO_PARAMS[distro]
        params = {k: _parse_param(k, getattr(self, f"{distro}_{k}")) for k in pdef}
        shape = tuple(ctx.shape)
        # vector params without event dims broadcast into one trailing dim
        if _EVENT_DIMS.get(distro, 0) == 0 and distro not in _SIMPLE:
            klen = max((v.shape[0] for v in params.values()
                        if isinstance(v, np.ndarray) and v.ndim), default=1)
            if klen > 1:
                shape = shape + (klen,)
        return fn(seed, params, shape, work_dtype(ctx.dtype), default_device(ctx.device))

    def generate(self, ctx, state, seed, sigma, sigma_next):
        token = _CTX.set(ctx)  # the draws read the shard from it
        try:
            noise = self.raw(ctx, seed)
        finally:
            _CTX.reset(token)
        # trim extra trailing dims via result_index cycling
        ris = self._result_indices()
        trim = 0
        while noise.ndim > len(ctx.shape):
            idx = ris[trim % len(ris)]
            if idx < 0:
                idx = noise.shape[-1] + idx
            noise = noise[..., max(0, min(noise.shape[-1] - 1, idx))]
            trim += 1
        noise = ctx.across(
            quantile_dims(self.quantile_norm_dim, self.quantile_norm_flatten, noise.ndim),
            lambda n: quantile_normalize(
                n,
                quantile=self.quantile_norm,
                dim=self.quantile_norm_dim,
                flatten=self.quantile_norm_flatten,
                nq_fac=self.quantile_norm_fac,
                pow_fac=self.quantile_norm_pow,
            ), noise).reshape(ctx.shape)
        return noise.to(ctx.dtype), state


__all__ = ["DISTRO_PARAMS", "DistroGenerator", "build_params"]
