"""Sigma schedules (port of ``sonar_tpu.samplers.schedules``): the
ComfyUI/k-diffusion scheduler family.

The reference relies on its host for schedules (workflows carry a
``BasicScheduler`` node with a scheduler name); a standalone framework
must provide them. These are the standard public algorithms (Karras et
al. 2022 rho-ramp; k-diffusion exponential/polyexponential; ComfyUI's
table-derived normal/sgm_uniform/simple/ddim_uniform/beta), reimplemented
against the :mod:`sonar_tpu_torch.cfg.model_sampling` protocol. They are
host arithmetic in numpy (float64, then float32).

All functions return a DESCENDING float32 CPU tensor with a trailing 0.0
(``steps + 1`` entries), the convention every sampler here consumes; the
samplers read it on the host once per run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SCHEDULERS", "get_sigmas", "karras_sigmas", "exponential_sigmas",
           "polyexponential_sigmas"]


def _finish(sigs) -> torch.Tensor:
    return torch.from_numpy(np.append(np.asarray(sigs, np.float64), 0.0).astype(np.float32))


def karras_ramp(steps: int, sigma_min: float, sigma_max: float,
                rho: float = 7.0) -> np.ndarray:
    """Raw Karras rho-ramp, no trailing zero (shared with
    samplers.restart's sub-schedules)."""
    ramp = np.linspace(0.0, 1.0, steps)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return np.asarray((hi + ramp * (lo - hi)) ** rho, np.float32)


def karras_sigmas(steps: int, sigma_min: float, sigma_max: float,
                  rho: float = 7.0) -> torch.Tensor:
    return _finish(karras_ramp(steps, sigma_min, sigma_max, rho))


def exponential_sigmas(steps: int, sigma_min: float,
                       sigma_max: float) -> torch.Tensor:
    return _finish(np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min),
                                      steps)))


def polyexponential_sigmas(steps: int, sigma_min: float, sigma_max: float,
                           rho: float = 1.0) -> torch.Tensor:
    ramp = np.linspace(1.0, 0.0, steps) ** rho
    return _finish(np.exp(ramp * (np.log(sigma_max) - np.log(sigma_min))
                          + np.log(sigma_min)))


def _table(ms) -> np.ndarray:
    """Ascending per-timestep sigma table of a model_sampling object."""
    sigmas = getattr(ms, "sigmas", None)
    if sigmas is None:
        # continuous models: synthesize a 1000-entry table via sigma(t)
        t = np.arange(1000, dtype=np.float64)
        lo = np.log(ms.sigma_min)
        hi = np.log(ms.sigma_max)
        return np.exp(lo + (t / 999.0) * (hi - lo))
    return np.asarray(sigmas, np.float64)


def _sigma_of_t(ms, t):
    table = _table(ms)
    return np.interp(t, np.arange(len(table)), table)


def normal_sigmas(ms, steps: int, *, sgm: bool = False) -> torch.Tensor:
    start = float(ms.timestep(ms.sigma_max))
    end = float(ms.timestep(ms.sigma_min))
    if sgm:
        ts = np.linspace(start, end, steps + 1)[:-1]
    else:
        ts = np.linspace(start, end, steps)
    return _finish(_sigma_of_t(ms, ts))


def simple_sigmas(ms, steps: int) -> torch.Tensor:
    table = _table(ms)
    ss = len(table) / steps
    return _finish([table[-(1 + int(x * ss))] for x in range(steps)])


def ddim_uniform_sigmas(ms, steps: int) -> torch.Tensor:
    table = _table(ms)
    ss = max(len(table) // steps, 1)
    sigs = [table[x] for x in range(1, len(table), ss)]
    return _finish(sigs[::-1])


def beta_sigmas(ms, steps: int, alpha: float = 0.6,
                beta: float = 0.6) -> torch.Tensor:
    from scipy import stats

    table = _table(ms)
    total = len(table) - 1
    ts = 1.0 - np.linspace(0.0, 1.0, steps, endpoint=False)
    idx = np.rint(stats.beta.ppf(ts, alpha, beta) * total).astype(int)
    # skip consecutive duplicate timesteps (upstream ``last_t != t`` filter):
    # colliding ppf values would otherwise emit repeated sigmas and no-op
    # sigma_next == sigma steps
    keep = np.concatenate([[True], idx[1:] != idx[:-1]])
    return _finish(table[idx[keep]])


def kl_optimal_sigmas(steps: int, sigma_min: float,
                      sigma_max: float) -> torch.Tensor:
    """KL-optimal spacing (Align Your Steps, Sabour et al. 2024 eq. 14):
    sigma_i = tan of a linear ramp in atan-sigma space."""
    t = np.linspace(0.0, 1.0, steps)
    return _finish(np.tan((1.0 - t) * np.arctan(sigma_max)
                          + t * np.arctan(sigma_min)))


def linear_quadratic_sigmas(steps: int, threshold_noise: float = 0.025,
                            linear_steps: int | None = None) -> torch.Tensor:
    """Linear-quadratic schedule (LTX-Video style, on the 0-1 noise scale):
    linear to ``threshold_noise`` over the first segment, quadratic decay
    after."""
    if steps == 1:
        return torch.tensor([1.0, 0.0], dtype=torch.float32)
    lin = steps // 2 if linear_steps is None else min(linear_steps, steps)
    ts = [i * threshold_noise / lin for i in range(lin)]
    quad_steps = steps - lin
    if quad_steps:
        # upstream C1-continuous quadratic tail (ComfyUI/genmo
        # linear_quadratic_schedule): the quadratic segment matches the
        # linear segment's value AND slope at the junction
        tnsd = lin - threshold_noise * steps
        quadratic_coef = tnsd / (lin * quad_steps**2)
        linear_coef = threshold_noise / lin - 2.0 * tnsd / quad_steps**2
        const = quadratic_coef * lin**2
        ts += [quadratic_coef * i**2 + linear_coef * i + const
               for i in range(lin, steps)]
    # upstream appends 1.0 then maps x -> 1-x; the trailing 0.0 from
    # _finish is exactly that final entry
    return _finish(1.0 - np.asarray(ts))


def _or_default(val, default):
    """Explicit None check — `or` would silently replace a legal 0.0."""
    return default if val is None else val


SCHEDULERS = {
    "normal": lambda ms, n, **kw: normal_sigmas(ms, n),
    "sgm_uniform": lambda ms, n, **kw: normal_sigmas(ms, n, sgm=True),
    "karras": lambda ms, n, **kw: karras_sigmas(
        n, _or_default(kw.get("sigma_min"), ms.sigma_min),
        _or_default(kw.get("sigma_max"), ms.sigma_max), rho=kw.get("rho", 7.0)),
    "exponential": lambda ms, n, **kw: exponential_sigmas(
        n, _or_default(kw.get("sigma_min"), ms.sigma_min),
        _or_default(kw.get("sigma_max"), ms.sigma_max)),
    "polyexponential": lambda ms, n, **kw: polyexponential_sigmas(
        n, _or_default(kw.get("sigma_min"), ms.sigma_min),
        _or_default(kw.get("sigma_max"), ms.sigma_max), rho=kw.get("rho", 1.0)),
    "simple": lambda ms, n, **kw: simple_sigmas(ms, n),
    "ddim_uniform": lambda ms, n, **kw: ddim_uniform_sigmas(ms, n),
    "beta": lambda ms, n, **kw: beta_sigmas(
        ms, n, alpha=kw.get("alpha", 0.6), beta=kw.get("beta", 0.6)),
    "kl_optimal": lambda ms, n, **kw: kl_optimal_sigmas(
        n, _or_default(kw.get("sigma_min"), ms.sigma_min),
        _or_default(kw.get("sigma_max"), ms.sigma_max)),
    "linear_quadratic": lambda ms, n, **kw: linear_quadratic_sigmas(
        n, threshold_noise=kw.get("threshold_noise", 0.025),
        linear_steps=kw.get("linear_steps")),
}


def get_sigmas(scheduler: str, steps: int, model_sampling=None, *,
               denoise: float = 1.0, **kwargs) -> torch.Tensor:
    """Build a ``steps + 1`` descending sigma schedule by scheduler name.

    ``denoise < 1`` keeps only the final ``steps`` of a
    ``steps / denoise``-step schedule (ComfyUI BasicScheduler semantics);
    ``denoise <= 0`` returns an empty schedule."""
    if scheduler not in SCHEDULERS:
        valid = ", ".join(sorted(SCHEDULERS))
        raise ValueError(f"Unknown scheduler {scheduler!r}; valid: {valid}")
    if model_sampling is None:
        from ..cfg.model_sampling import DiscreteSampling

        model_sampling = DiscreteSampling()
    if denoise < 0.9999:
        if denoise <= 0.0:
            return torch.zeros((0,), dtype=torch.float32)
        total = int(steps / denoise)
        full = SCHEDULERS[scheduler](model_sampling, total, **kwargs)
        return full[-(steps + 1):]
    return SCHEDULERS[scheduler](model_sampling, steps, **kwargs)
