"""DPM-Solver fast / adaptive (arXiv:2206.00927) under their ComfyUI registry
names (port of ``sonar_tpu.samplers.dpm_solver``).

These two k-diffusion samplers do not consume the sigma table step by step:
``dpm_fast`` re-grids [t_start, t_end] uniformly in t = -log(sigma) and runs
singlestep order-3/2/1 segments; ``dpm_adaptive`` picks its own steps with a
PID controller. Both mirror ComfyUI's wrappers: sigma_max = sigmas[0],
sigma_min = the last nonzero sigma, nfe = len(sigmas) - 1; like the host
versions they land at sigma_min, not 0.

- ``dpm_fast``: the segment plan and every coefficient are host numbers,
  from the schedule alone; a segment is its model calls and linear
  combinations with host weights, and reads nothing back.
- ``dpm_adaptive``: accepting or rejecting an attempt needs its error
  estimate on the host, so each attempt reads one number back from the card
  (the reference's host loop does the same). That read is the one
  synchronisation a step of the registry makes. The controller (the
  position ``s``, the PID step ``h`` and the three inverse errors) runs in
  float32, as the JAX package carries it in float32 device scalars through
  its ``while_loop``, so the sequence of accepts is the JAX package's.
  Noise draws (``eta > 0``) are made on accepted attempts only and indexed
  by the attempt counter, rejected attempts included; ``max_steps`` bounds
  the attempts (the reference loop is unbounded).

Neither takes a ``callback``: like the JAX package they raise
``NotImplementedError`` for one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ancestral import get_ancestral_step
from .momentum import SonarConfig
from ..parallel.mesh import all_reduce
from .sonar import _host_sigmas, _setup, current_shard, sharded

__all__ = ["sample_dpm_fast", "sample_dpm_adaptive", "DPM_SOLVER_SAMPLERS"]

_F = np.float32


def _sigma_grid(sigmas, name):
    sig = _host_sigmas(sigmas).numpy().astype(np.float64)
    if sig.shape[0] < 2:
        raise ValueError(f"{name} needs at least 2 sigmas")
    sigma_max = float(sig[0])
    sigma_min = float(sig[-1]) if sig[-1] > 0 else float(sig[-2])
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must not be 0")
    n = sig.shape[0] - 1
    return sigma_max, sigma_min, n


def _fast_segments(sigma_max, sigma_min, nfe, eta):
    """Static segment plan: (order, per-segment dict of float coefficients)."""
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    m = nfe // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1)
    if nfe % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [nfe % 3]
    sigma = lambda t: math.exp(-t)  # noqa: E731
    segs = []
    for i, order in enumerate(orders):
        t, t_next = float(ts[i]), float(ts[i + 1])
        if eta:
            sg, sn = sigma(t), sigma(t_next)
            su0 = min(sn, eta * math.sqrt(sn**2 * (sg**2 - sn**2) / sg**2))
            sd = math.sqrt(max(sn**2 - su0**2, 0.0))
            t_next_ = min(t_end, -math.log(max(sd, 1e-12)))
            su = math.sqrt(max(sn**2 - sigma(t_next_) ** 2, 0.0))
        else:
            t_next_, su = t_next, 0.0
        h = t_next_ - t
        seg = {"sigma_t": sigma(t), "su": su,
               "sigma_from": sigma(t), "sigma_to": sigma(t_next),
               "k_eps": sigma(t_next_) * math.expm1(h)}
        if order >= 2:
            r1 = 0.5 if order == 2 else 1.0 / 3.0
            s1 = t + r1 * h
            seg["sigma_s1"] = sigma(s1)
            seg["k_u1"] = sigma(s1) * math.expm1(r1 * h)
            if order == 2:
                seg["k_d1"] = sigma(t_next_) / (2.0 * r1) * math.expm1(h)
        if order == 3:
            r1, r2 = 1.0 / 3.0, 2.0 / 3.0
            s2 = t + r2 * h
            seg["sigma_s2"] = sigma(s2)
            seg["k_u2"] = sigma(s2) * math.expm1(r2 * h)
            seg["k_u2d"] = (sigma(s2) * (r2 / r1)
                            * (math.expm1(r2 * h) / (r2 * h) - 1.0))
            seg["k_d2"] = (sigma(t_next_) / r2
                           * (math.expm1(h) / h - 1.0))
        segs.append((order, seg))
    return segs


def _seg_step(model_fn, x, order, seg, noise, s_noise):
    """One singlestep DPM-Solver segment (order 1/2/3) with host coefficients
    (the JAX package rounds them to float32, as a float32 tensor rounds a
    host number it is multiplied by); ``noise`` is None or the drawn
    ancestral noise."""
    c = {k: float(_F(v)) for k, v in seg.items()}
    eps = (x - model_fn(x, c["sigma_t"])) / c["sigma_t"]
    if order == 1:
        out = x - eps * c["k_eps"]
    elif order == 2:
        u1 = x - eps * c["k_u1"]
        eps_r1 = (u1 - model_fn(u1, c["sigma_s1"])) / c["sigma_s1"]
        out = x - eps * c["k_eps"] - (eps_r1 - eps) * c["k_d1"]
    else:
        u1 = x - eps * c["k_u1"]
        eps_r1 = (u1 - model_fn(u1, c["sigma_s1"])) / c["sigma_s1"]
        u2 = x - eps * c["k_u2"] - (eps_r1 - eps) * c["k_u2d"]
        eps_r2 = (u2 - model_fn(u2, c["sigma_s2"])) / c["sigma_s2"]
        out = x - eps * c["k_eps"] - (eps_r2 - eps) * c["k_d2"]
    if noise is not None:
        out = out + noise * (s_noise * c["su"])
    return out


@sharded
def sample_dpm_fast(
    model,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 0.0,
    s_noise: float = 1.0,
    noise_item=None,
    noise_sampler=None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
) -> torch.Tensor:
    """k-diffusion ``sample_dpm_fast`` via ComfyUI's wrapper (nfe =
    len(sigmas) - 1 over [sigmas[0], last nonzero sigma]); with ``eta > 0``
    each segment draws once, indexed by the segment."""
    if callback is not None:
        raise NotImplementedError(
            "dpm_fast runs order-grouped segments, not per-sigma steps — "
            "callback is not supported")
    sigma_max, sigma_min, nfe = _sigma_grid(sigmas, "dpm_fast")
    st = _setup(model, x, sigmas, cfg=SonarConfig(), default_noise_type="gaussian",
                noise_item=noise_item, noise_sampler=noise_sampler, seed=seed,
                extra_args=extra_args, need_noise=eta > 0)
    nstate = st.noise_state
    wide = torch.promote_types(x.dtype, torch.float32)
    for idx, (order, seg) in enumerate(_fast_segments(sigma_max, sigma_min, nfe, eta)):
        noise = None
        if eta:
            noise, nstate = st.noise_fn(nstate, idx, float(_F(seg["sigma_from"])),
                                        float(_F(seg["sigma_to"])))
            noise = noise.to(wide)
        x = _seg_step(st.model_fn, x, order, seg, noise, s_noise).to(x.dtype)
    return x


@sharded
def sample_dpm_adaptive(
    model,
    x: torch.Tensor,
    sigmas,
    *,
    order: int = 3,
    rtol: float = 0.05,
    atol: float = 0.0078,
    h_init: float = 0.05,
    pcoeff: float = 0.0,
    icoeff: float = 1.0,
    dcoeff: float = 0.0,
    accept_safety: float = 0.81,
    eta: float = 0.0,
    s_noise: float = 1.0,
    noise_item=None,
    noise_sampler=None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    max_steps: int = 1000,
) -> torch.Tensor:
    """k-diffusion ``sample_dpm_adaptive``: PID-controlled adaptive
    DPM-Solver over [sigmas[0], last nonzero sigma]; ``max_steps`` bounds
    the attempts (a NaN error estimate would loop forever otherwise). One
    host read an attempt: its error estimate, on a shard the norm of the
    whole latent's (the ranks' squares summed)."""
    if callback is not None:
        raise NotImplementedError("dpm_adaptive picks its own steps — callback is not supported")
    if order not in (2, 3):
        raise ValueError("order should be 2 or 3")
    sigma_max, sigma_min, _n = _sigma_grid(sigmas, "dpm_adaptive")
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    st = _setup(model, x, sigmas, cfg=SonarConfig(), default_noise_type="gaussian",
                noise_item=noise_item, noise_sampler=noise_sampler, seed=seed,
                extra_args=extra_args, need_noise=eta > 0)
    model_fn = st.model_fn
    nstate = st.noise_state
    wide = torch.promote_types(x.dtype, torch.float32)
    pid_order = 1.5 if eta else order
    b1 = _F((pcoeff + icoeff + dcoeff) / pid_order)
    b2 = _F(-(pcoeff + 2.0 * dcoeff) / pid_order)
    b3 = _F(dcoeff / pid_order)
    shard = current_shard()
    # the whole latent's norm: each rank's squares summed over the ranks, so
    # that every rank accepts and rejects the same attempts
    root_numel = math.sqrt(float(np.prod(x.shape if shard is None else shard.global_shape)))
    one, t_end32 = _F(1.0), _F(t_end)

    def sigma_of(t):
        return np.exp(-t)

    def solver_step(xc, s, t_, r1, with_third):
        """Shared-eps 2-step (x_low path) and optional 3-step (x_high)."""
        h = t_ - s
        hs = _F(1e-12) if h == 0 else h
        sig_s, sig_t_, em = sigma_of(s), sigma_of(t_), np.expm1(h)
        eps = (xc - model_fn(xc, float(sig_s))) / float(sig_s)
        sig_s1 = sigma_of(s + _F(r1) * h)
        u1 = xc - eps * float(sig_s1 * np.expm1(_F(r1) * h))
        eps_r1 = (u1 - model_fn(u1, float(sig_s1))) / float(sig_s1)
        x1 = xc - eps * float(sig_t_ * em)
        x2 = x1 - (eps_r1 - eps) * float(sig_t_ / _F(2.0 * r1) * em)
        if not with_third:
            return x1, x2
        r2 = _F(2.0 / 3.0)
        sig_s2 = sigma_of(s + r2 * h)
        u2 = (xc - eps * float(sig_s2 * np.expm1(r2 * h))
              - (eps_r1 - eps) * float(sig_s2 * _F(2.0 / 3.0 / r1)
                                       * (np.expm1(r2 * h) / (r2 * hs) - one)))
        eps_r2 = (u2 - model_fn(u2, float(sig_s2))) / float(sig_s2)
        x3 = x1 - (eps_r2 - eps) * float(sig_t_ / r2 * (em / hs - one))
        return x2, x3

    xc, x_prev = x, x
    s, h_pid = _F(t_start), _F(abs(h_init))
    errs = np.zeros(3, np.float32)
    it = 0
    while s < _F(t_end - 1e-5) and it < max_steps:
        t = np.minimum(t_end32, s + h_pid)
        if eta:
            sd, _su = get_ancestral_step(sigma_of(s), sigma_of(t), eta=eta)
            t_ = np.minimum(t_end32, -np.log(np.maximum(_F(float(sd)), _F(1e-12))))
            su = np.sqrt(np.maximum(sigma_of(t) ** 2 - sigma_of(t_) ** 2, _F(0.0)))
        else:
            t_, su = t, _F(0.0)
        xw = xc.to(wide)
        x_low, x_high = solver_step(xw, s, t_, 0.5 if order == 2 else 1.0 / 3.0,
                                    with_third=order == 3)
        delta = torch.clamp(torch.maximum(x_low.abs(), x_prev.to(wide).abs()) * rtol, min=atol)
        scaled = (x_low - x_high) / delta
        if shard is None:
            error = torch.linalg.vector_norm(scaled) / root_numel
        else:
            squares = all_reduce(torch.sum(scaled.double() ** 2).reshape(1), shard.groups)
            error = torch.sqrt(squares[0]) / root_numel
        inv_err = one / (_F(error.item()) + _F(1e-8))  # the attempt's one host read
        if it == 0:
            errs[:] = inv_err
        errs[0] = inv_err
        factor = one + np.arctan(errs[0] ** b1 * errs[1] ** b2 * errs[2] ** b3 - one)
        if factor >= _F(accept_safety):
            if eta:
                noise, nstate = st.noise_fn(nstate, it, float(sigma_of(s)), float(sigma_of(t)))
                x_high = x_high + noise.to(wide) * float(_F(s_noise) * su)
            xc, x_prev, s = x_high.to(x.dtype), x_low.to(x.dtype), t
            errs[1:] = errs[:2].copy()
        h_pid = h_pid * factor
        it += 1
    return xc


DPM_SOLVER_SAMPLERS = {
    "dpm_fast": sample_dpm_fast,
    "dpm_adaptive": sample_dpm_adaptive,
}

# both re-grid the schedule on the host
for _fn in DPM_SOLVER_SAMPLERS.values():
    _fn._needs_host_sigmas = True
