"""Plain k-diffusion samplers (port of ``sonar_tpu.samplers.kdiffusion``;
formulas of ``comfy.k_diffusion.sampling``).

The reference wraps host samplers with custom noise through
SamplerConfigOverride (py/nodes/misc.py:461-625), and its own example corpus
samples with ``dpmpp_2s_ancestral`` (docs/base_noise_types.md:3-9), so the
plain k-diffusion set is part of the registry.

Host loops on host sigmas, as the sonar samplers (:mod:`.sonar`): the
schedule is read once a run, and every branch that the JAX package computes
on both sides and selects elementwise (the ``sigma_next == 0`` tail, a
``sigma_down == 0`` floor, the churn window) is decided on the host. So:

- a second-order sampler makes no model call whose result JAX computes and
  throws away: on a schedule that ends at 0, heun, dpm_2, dpm_2_ancestral
  and dpmpp_2s_ancestral make one model call fewer a run than the JAX
  program evaluates, and heunpp2 three fewer;
- noise is drawn exactly where the JAX program draws it, under its
  ``lax.cond`` gates and unconditionally where it draws unconditionally
  (euler_ancestral, dpmpp_2s_ancestral, lcm and the SDE pair draw on the
  tail step too), so a stateful stream (Brownian, a recorded one) sees the
  same sequence of draws.

Per-step scalars are float32 numpy scalars on the host, as JAX computes them
in float32 on the device. A step widens what it reads to float32 (a bf16
latent is stepped in float32, as JAX's float32 sigmas promote it; the first
model call of a step sees the carry in its own type, the later ones a
float32 latent), and ``_run_loop`` rounds the carry back once a step. A step
reads nothing back from the card.

Checkpoint/resume, ``callback`` and ``method=`` come from the shared
``_run_loop``: the carry is ``(x, aux_state, noise_state)``; the history of
the multistep samplers rides in ``aux_state``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..noise.base import NoiseItem
from .ancestral import get_ancestral_step, to_d
from .momentum import SonarConfig
from .sonar import _host_sigmas, _run_loop, _setup, sample_sonar_dpmpp_sde, sharded

__all__ = [
    "sample_euler",
    "sample_euler_ancestral",
    "sample_heun",
    "sample_heunpp2",
    "sample_dpm_2",
    "sample_dpm_2_ancestral",
    "sample_dpmpp_2m",
    "sample_dpmpp_2s_ancestral",
    "sample_dpmpp_sde",
    "sample_dpmpp_2m_sde",
    "sample_dpmpp_3m_sde",
    "sample_ddim",
    "sample_ddpm",
    "sample_lcm",
    "sample_res_multistep",
    "sample_res_multistep_ancestral",
    "KDIFFUSION_SAMPLERS",
]

_F = np.float32
_EPS = _F(1e-10)


def _kd_setup(model, x, sigmas, *, default_noise_type, noise_item, noise_sampler, seed,
              extra_args, need_noise):
    """Model/noise plumbing shared with the sonar family (``_setup`` with a
    default SonarConfig: no momentum state, no guidance, no rand init), and
    the schedule as a float32 numpy vector."""
    st = _setup(model, x, sigmas, cfg=SonarConfig(), default_noise_type=default_noise_type,
                noise_item=noise_item, noise_sampler=noise_sampler, seed=seed,
                extra_args=extra_args, need_noise=need_noise)
    return st, np.asarray(st.sigmas, np.float32)


def _wide(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _splits(sig: np.ndarray, eta: float):
    """``get_ancestral_step`` over the whole schedule in float32: the
    per-step sigma_down and sigma_up as float32 numpy vectors."""
    s = torch.from_numpy(sig)
    sd, su = get_ancestral_step(s[:-1], s[1:], eta=eta)
    return (torch.broadcast_to(sd, s[:-1].shape).numpy().astype(np.float32),
            torch.broadcast_to(su, s[:-1].shape).numpy().astype(np.float32))


def _in_window(sigma, s_tmin: float, s_tmax: float) -> bool:
    return bool(_F(s_tmin) <= sigma <= _F(s_tmax))


def _churn(sigma, s_churn: float, s_tmin: float, s_tmax: float, n_steps: int):
    """Karras churn amount for a step (float32), 0 outside the window."""
    gamma = min(s_churn / max(n_steps, 1), math.sqrt(2.0) - 1.0)
    return _F(gamma) if _in_window(sigma, s_tmin, s_tmax) else _F(0.0)


def _churn_window(sigmas: np.ndarray, s_churn: float, s_tmin: float, s_tmax: float) -> bool:
    """Whether churn draws at all: not when ``s_churn`` is 0 or no step's
    sigma lands in ``[s_tmin, s_tmax]`` (the run then makes no draw)."""
    if not s_churn > 0:
        return False
    vals = sigmas[:-1]
    return bool(((vals >= _F(s_tmin)) & (vals <= _F(s_tmax))).any())


def _gated_draw(noise_fn, nstate, i, sigma, sigma_next, s_tmin, s_tmax):
    """Draw only inside the churn window, as the reference calls
    noise_sampler only when ``gamma > 0`` (k-diffusion sample_euler), so a
    stateful stream sees the reference's draws; outside, no noise (None) and
    the stream state untouched."""
    if not _in_window(sigma, s_tmin, s_tmax):
        return None, nstate
    return noise_fn(nstate, i, float(sigma), float(sigma_next))


def _churned(st, xc, nstate, i, sig, wide, churn):
    """The Karras churn of euler/heun/dpm_2/heunpp2: ``(x raised to
    sigma_hat, sigma_hat, noise state)``."""
    s_churn, s_tmin, s_tmax, s_noise = churn
    sigma, sigma_next = sig[i], sig[i + 1]
    gamma = _churn(sigma, s_churn, s_tmin, s_tmax, len(sig) - 1)
    sigma_hat = sigma * (gamma + _F(1.0))
    noise, nstate = _gated_draw(st.noise_fn, nstate, i, sigma, sigma_next, s_tmin, s_tmax)
    if noise is not None:
        bump = np.sqrt(np.maximum(sigma_hat**2 - sigma**2, _F(0.0)))
        xc = xc.to(wide) + noise.to(wide) * float(_F(s_noise) * bump)
    return xc, sigma_hat, nstate


def _info(out, sigma, sigma_hat, denoised):
    return {"x": out, "sigma": float(sigma), "sigma_hat": float(sigma_hat),
            "denoised": denoised}


@sharded
def sample_euler(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_euler``: deterministic Euler with optional Karras
    churn. Noise is drawn only when ``s_churn > 0`` and the step's sigma lies
    in ``[s_tmin, s_tmax]``."""
    need_noise = _churn_window(_host_sigmas(sigmas).numpy(), s_churn, s_tmin, s_tmax)
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=need_noise)
    wide = _wide(x)
    churn = (s_churn, s_tmin, s_tmax, s_noise)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma_hat = sig[i]
        if need_noise:
            xc, sigma_hat, nstate = _churned(st, xc, nstate, i, sig, wide, churn)
        denoised = st.model_fn(xc, float(sigma_hat))
        d = to_d(xc.to(wide), float(sigma_hat), denoised.to(wide))
        out = xc.to(wide) + d * float(sig[i + 1] - sigma_hat)
        return (out, aux, nstate), _info(out, sig[i], sigma_hat, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_euler_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_euler_ancestral`` (the momentum-free core of
    sample_sonar_euler_ancestral, its own loop without kernel B1)."""
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    sd, su = _splits(sig, eta)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        xw = xc.to(wide)
        out = xw + to_d(xw, float(sigma), denoised.to(wide)) * float(sd[i] - sigma)
        noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
        if sigma_next > 0:
            out = out + noise.to(wide) * float(_F(s_noise) * su[i])
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_heun(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_heun``: trapezoidal second-order correction; the
    ``sigma_next == 0`` step is the Euler step and makes one model call."""
    need_noise = _churn_window(_host_sigmas(sigmas).numpy(), s_churn, s_tmin, s_tmax)
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=need_noise)
    wide = _wide(x)
    churn = (s_churn, s_tmin, s_tmax, s_noise)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma_hat, sigma_next = sig[i], sig[i + 1]
        if need_noise:
            xc, sigma_hat, nstate = _churned(st, xc, nstate, i, sig, wide, churn)
        denoised = st.model_fn(xc, float(sigma_hat))
        xw = xc.to(wide)
        d = to_d(xw, float(sigma_hat), denoised.to(wide))
        dt = sigma_next - sigma_hat
        out = xw + d * float(dt)
        if sigma_next > 0:
            d_2 = to_d(out, float(sigma_next), st.model_fn(out, float(sigma_next)).to(wide))
            out = xw + (d + d_2) * float(_F(0.5) * dt)
        return (out, aux, nstate), _info(out, sig[i], sigma_hat, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_dpmpp_2m(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    extra_args: dict | None = None,
    seed: int | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpmpp_2m``: deterministic second-order multistep
    (one model call a step; the previous denoised rides the carry)."""
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=None,
                        noise_sampler=None, seed=seed, extra_args=extra_args, need_noise=False)
    wide = _wide(x)

    def t_fn(s):
        return -np.log(np.maximum(s, _EPS))

    def step_fn(carry, i):
        xc, (old_denoised, has_old), nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        eff = denoised.to(wide)
        t, t_next = t_fn(sigma), t_fn(sigma_next)
        h = t_next - t
        # second order only with history and off the tail (k-diffusion:
        # `old_denoised is None or sigmas[i + 1] == 0`)
        if has_old and sigma_next > 0 and i > 0:
            r = (t - t_fn(sig[i - 1])) / (_EPS if h == 0 else h)
            coef = _F(1.0) / np.maximum(_F(2.0) * r, _EPS)
            eff = eff * float(_F(1.0) + coef) - old_denoised.to(wide) * float(coef)
        out = xc.to(wide) * float(sigma_next / sigma) - eff * float(np.expm1(-h))
        return (out, (denoised, True), nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (torch.zeros_like(x), False), (),
                     callback=callback, method=method, resume_from=resume_from,
                     start_step=start_step, stop_step=stop_step, return_state=return_state)


@sharded
def sample_dpmpp_2s_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpmpp_2s_ancestral``: single-step second-order
    DPM-Solver++ with ancestral noise, the sampler of the reference's own
    example corpus. A step with ``sigma_down == 0`` is the Euler step (one
    model call); every step draws."""
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    sd, su = _splits(sig, eta)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma, sigma_next, sigma_down = sig[i], sig[i + 1], sd[i]
        denoised = st.model_fn(xc, float(sigma))
        xw, dw = xc.to(wide), denoised.to(wide)
        if sigma_down > 0:  # DPM-Solver++(2S)
            sd_safe = np.maximum(sigma_down, _EPS)
            t, t_next = -np.log(sigma), -np.log(sd_safe)
            h = t_next - t
            sigma_s = np.exp(-(t + _F(0.5) * h))
            x_2 = xw * float(sigma_s / sigma) - dw * float(np.expm1(-h * _F(0.5)))
            denoised_2 = st.model_fn(x_2, float(sigma_s)).to(wide)
            out = xw * float(sd_safe / sigma) - denoised_2 * float(np.expm1(-h))
        else:  # Euler
            out = xw + to_d(xw, float(sigma), dw) * float(sigma_down - sigma)
        noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
        if sigma_next > 0:
            out = out + noise.to(wide) * float(_F(s_noise) * su[i])
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_ddim(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 0.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """DDIM in the sigma parameterization: ``x <- denoised +
    (sigma_down/sigma) * (x - denoised)``; ``eta = 0`` is the Euler ODE step,
    ``eta > 0`` re-injects ``sigma_up`` of noise (stochastic DDIM)."""
    need_noise = eta > 0
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=need_noise)
    sd, su = _splits(sig, eta) if need_noise else (sig[1:], None)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        dw = denoised.to(wide)
        out = dw + (xc.to(wide) - dw) * float(sd[i] / sigma)
        if need_noise:
            noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
            if sigma_next > 0:
                out = out + noise.to(wide) * float(_F(s_noise) * su[i])
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_lcm(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    ancestral_mode: str = "vp",
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """LCM sampler (comfy ``sample_lcm``): the consistency prediction,
    re-noised to the next sigma by VP (``denoised + sigma_next * noise``) or
    rectified-flow (``(1 - sigma_next) * denoised + sigma_next * noise``)
    noise scaling, chosen like the sonar samplers' ``ancestral_mode``."""
    if ancestral_mode not in ("vp", "rf"):
        raise ValueError(f"ancestral_mode must be 'vp' or 'rf', got {ancestral_mode!r}")
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    rf = ancestral_mode == "rf"
    wide = _wide(x)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        out = denoised.to(wide)
        noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
        if sigma_next > 0:
            base = out * float(_F(1.0) - sigma_next) if rf else out
            out = base + noise.to(wide) * float(_F(s_noise) * sigma_next)
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_dpmpp_2m_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    solver_type: str = "midpoint",
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpmpp_2m_sde``: multistep SDE DPM-Solver++.
    Default noise is brownian, like the reference's SDE family
    (py/sonar.py:627). ``solver_type``: "midpoint" (default) or "heun". With
    ``eta`` every step draws, the tail too; the tail returns the denoised."""
    if solver_type not in ("midpoint", "heun"):
        raise ValueError(f"solver_type must be 'midpoint' or 'heun', got {solver_type!r}")
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="brownian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, (old_denoised, h_last, has), nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        out = denoised.to(wide)
        sn_safe = np.maximum(sigma_next, _EPS)
        h = np.log(sigma) - np.log(sn_safe)  # h = t_next - t, t = -log sigma
        eta_h = _F(eta) * h
        if sigma_next > 0:
            em = np.expm1(-h - eta_h)
            out = xc.to(wide) * float(sn_safe / sigma * np.exp(-eta_h)) - out * float(em)
            if has and i > 0:
                inv_r = _F(1.0) / np.maximum(h_last / (_EPS if h == 0 else h), _EPS)
                if solver_type == "heun":
                    corr = (em / (_EPS if h + eta_h == 0 else h + eta_h) + _F(1.0)) * inv_r
                else:
                    corr = _F(-0.5) * em * inv_r
                out = out + (denoised.to(wide) - old_denoised.to(wide)) * float(corr)
        if eta:
            noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
            if sigma_next > 0:
                bump = np.sqrt(np.maximum(-np.expm1(_F(-2.0) * eta_h), _F(0.0)))
                out = out + noise.to(wide) * float(_F(s_noise) * sn_safe * bump)
        return (out, (denoised, h, True), nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (torch.zeros_like(x), _F(0.0), False),
                     st.noise_state, callback=callback, method=method,
                     resume_from=resume_from, start_step=start_step, stop_step=stop_step,
                     return_state=return_state)


@sharded
def sample_dpmpp_3m_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpmpp_3m_sde``: third-order multistep SDE solver;
    two denoised histories ride the carry, and the order-2 and order-3
    corrections start as history accumulates (the reference's ``h_1/h_2 is
    None`` ladder). Default noise brownian; every step draws with ``eta``."""
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="brownian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, (den_1, den_2, h_1, h_2, n_hist), nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        out = dw = denoised.to(wide)
        sn_safe = np.maximum(sigma_next, _EPS)
        h = np.log(sigma) - np.log(sn_safe)
        h_eta = h * _F(eta + 1.0)
        if sigma_next > 0:
            out = xc.to(wide) * float(np.exp(-h_eta)) - dw * float(np.expm1(-h_eta))
            hs = _EPS if h == 0 else h
            he = _EPS if h_eta == 0 else h_eta
            phi_2 = np.expm1(-h_eta) / he + _F(1.0)
            phi_3 = phi_2 / he - _F(0.5)
            if n_hist >= 1:
                r0 = h_1 / hs
                d1_0 = (dw - den_1.to(wide)) / float(np.maximum(r0, _EPS))
                if n_hist == 1:  # order 2
                    out = out + d1_0 * float(phi_2)
                else:  # order 3
                    r1 = h_2 / hs
                    d1_1 = (den_1.to(wide) - den_2.to(wide)) / float(np.maximum(r1, _EPS))
                    rsum = np.maximum(r0 + r1, _EPS)
                    d1 = d1_0 + (d1_0 - d1_1) * float(r0 / rsum)
                    d2 = (d1_0 - d1_1) / float(rsum)
                    out = out + d1 * float(phi_2) - d2 * float(phi_3)
        if eta:
            noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
            if sigma_next > 0:
                bump = np.sqrt(np.maximum(-np.expm1(_F(-2.0) * h * _F(eta)), _F(0.0)))
                out = out + noise.to(wide) * float(_F(s_noise) * sn_safe * bump)
        aux = (denoised, den_1, h, h_1, min(n_hist + 1, 2))
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    aux0 = (torch.zeros_like(x), torch.zeros_like(x), _F(0.0), _F(0.0), 0)
    return _run_loop(step_fn, x, len(sig) - 1, aux0, st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_dpmpp_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    r: float = 0.5,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpmpp_sde``: the plain two-stage SDE solver. With
    ``momentum == 1`` the sonar momentum machinery reduces exactly to the
    k-diffusion step, so this is ``sample_sonar_dpmpp_sde`` pinned at
    momentum 1: one implementation, two names."""
    return sample_sonar_dpmpp_sde(
        model, x, sigmas, sonar_config=SonarConfig(momentum=1.0), eta=eta, s_noise=s_noise,
        r=r, noise_item=noise_item, noise_sampler=noise_sampler, seed=seed,
        extra_args=extra_args, callback=callback, method=method, resume_from=resume_from,
        start_step=start_step, stop_step=stop_step, return_state=return_state)


@sharded
def sample_dpm_2(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpm_2`` (Karras DPM2): explicit midpoint in
    log-sigma space with optional churn; the ``sigma_next == 0`` step is the
    Euler step and makes one model call."""
    need_noise = _churn_window(_host_sigmas(sigmas).numpy(), s_churn, s_tmin, s_tmax)
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=need_noise)
    wide = _wide(x)
    churn = (s_churn, s_tmin, s_tmax, s_noise)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma_hat, sigma_next = sig[i], sig[i + 1]
        if need_noise:
            xc, sigma_hat, nstate = _churned(st, xc, nstate, i, sig, wide, churn)
        denoised = st.model_fn(xc, float(sigma_hat))
        xw = xc.to(wide)
        d = to_d(xw, float(sigma_hat), denoised.to(wide))
        if sigma_next > 0:
            # geometric midpoint: sigma_hat.log().lerp(sigma_next.log(), 0.5)
            sigma_mid = np.exp(_F(0.5) * (np.log(sigma_hat) + np.log(sigma_next)))
            x_2 = xw + d * float(sigma_mid - sigma_hat)
            d = to_d(x_2, float(sigma_mid), st.model_fn(x_2, float(sigma_mid)).to(wide))
        out = xw + d * float(sigma_next - sigma_hat)
        return (out, aux, nstate), _info(out, sig[i], sigma_hat, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_dpm_2_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """k-diffusion ``sample_dpm_2_ancestral``: DPM2 midpoint toward the
    ancestral ``sigma_down``, then ``sigma_up`` of noise. Like the reference
    it draws only inside the solver branch (``sigma_down > 0``); a step with
    ``sigma_down == 0`` is the Euler step, one model call and no draw."""
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    sd, su = _splits(sig, eta)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma, sigma_down = sig[i], sd[i]
        denoised = st.model_fn(xc, float(sigma))
        xw = xc.to(wide)
        d = to_d(xw, float(sigma), denoised.to(wide))
        if sigma_down > 0:
            sigma_mid = np.exp(_F(0.5) * (np.log(sigma) + np.log(np.maximum(sigma_down, _EPS))))
            x_2 = xw + d * float(sigma_mid - sigma)
            d_2 = to_d(x_2, float(sigma_mid), st.model_fn(x_2, float(sigma_mid)).to(wide))
            noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sig[i + 1]))
            out = xw + d_2 * float(sigma_down - sigma)
            out = out + noise.to(wide) * float(_F(s_noise) * su[i])
        else:
            out = xw + d * float(sigma_down - sigma)
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


@sharded
def sample_heunpp2(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """ComfyUI ``sample_heunpp2`` (Heun++, from the MIT-licensed
    sd-webui-samplers-scheduler): three-stage weighted correction with
    per-stage weights ``sigma / (k * sigmas[0])``. The step into the last
    sigma is the Euler step (one model call), the one before it the Heun
    step (two)."""
    need_noise = _churn_window(_host_sigmas(sigmas).numpy(), s_churn, s_tmin, s_tmax)
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=need_noise)
    n_steps = len(sig) - 1
    s_end = sig[-1]
    wide = _wide(x)
    churn = (s_churn, s_tmin, s_tmax, s_noise)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma_hat, sigma_next = sig[i], sig[i + 1]
        sigma_nn = sig[min(i + 2, n_steps)]
        if need_noise:
            xc, sigma_hat, nstate = _churned(st, xc, nstate, i, sig, wide, churn)
        denoised = st.model_fn(xc, float(sigma_hat))
        xw = xc.to(wide)
        d = to_d(xw, float(sigma_hat), denoised.to(wide))
        dt = float(sigma_next - sigma_hat)
        if sigma_next == s_end:  # Euler
            out = xw + d * dt
        else:
            sn_safe = float(np.maximum(sigma_next, _EPS))
            x_2 = xw + d * dt
            d_2 = to_d(x_2, sn_safe, st.model_fn(x_2, sn_safe).to(wide))
            if sigma_nn == s_end:  # Heun: weights (1 - w2, w2)
                w2 = sigma_next / (_F(2.0) * sig[0])
                out = xw + (d * float(_F(1.0) - w2) + d_2 * float(w2)) * dt
            else:  # Heun++: weights (1 - w2 - w3, w2, w3)
                snn_safe = float(np.maximum(sigma_nn, _EPS))
                x_3 = x_2 + d_2 * float(sigma_nn - sigma_next)
                d_3 = to_d(x_3, snn_safe, st.model_fn(x_3, snn_safe).to(wide))
                w2 = sigma_next / (_F(3.0) * sig[0])
                w3 = sigma_nn / (_F(3.0) * sig[0])
                out = xw + (d * float(_F(1.0) - w2 - w3) + d_2 * float(w2)
                            + d_3 * float(w3)) * dt
        return (out, aux, nstate), _info(out, sig[i], sigma_hat, denoised)

    return _run_loop(step_fn, x, n_steps, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


def _res_multistep(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    eta: float = 1.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """ComfyUI ``res_multistep`` (second-order exponential multistep, RES,
    arXiv:2308.02157): ``x <- exp(-h) x + h (b1 denoised + b2
    old_denoised)`` with ``b1 = phi1 - phi2/c2``, ``b2 = phi2/c2``, ``c2 =
    (t_old - t)/h``; Euler on the first step and where ``sigma_down == 0``.
    ``eta = 0`` is the deterministic sampler, ``eta > 0`` the ancestral one,
    which draws only where ``sigma_next > 0`` (the reference's guard)."""
    need_noise = eta > 0
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=need_noise)
    sd, su = _splits(sig, eta) if need_noise else (sig[1:], None)
    wide = _wide(x)

    def step_fn(carry, i):
        xc, (old_denoised, has_old), nstate = carry
        sigma, sigma_next, sigma_down = sig[i], sig[i + 1], sd[i]
        denoised = st.model_fn(xc, float(sigma))
        xw, dw = xc.to(wide), denoised.to(wide)
        if has_old and sigma_down > 0 and i > 0:  # RES second-order multistep
            t = -np.log(sigma)
            h = -np.log(np.maximum(sigma_down, _EPS)) - t
            hs, nh = (_EPS, _EPS) if h == 0 else (h, -h)
            c2 = (-np.log(sig[i - 1]) - t) / hs
            c2s = _EPS if c2 == 0 else c2
            phi1 = np.expm1(-h) / nh
            phi2 = (phi1 - _F(1.0)) / nh
            b1, b2 = phi1 - phi2 / c2s, phi2 / c2s
            out = xw * float(np.exp(-h)) + (dw * float(b1)
                                            + old_denoised.to(wide) * float(b2)) * float(h)
        else:  # Euler
            out = xw + to_d(xw, float(sigma), dw) * float(sigma_down - sigma)
        if need_noise and sigma_next > 0:
            noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
            out = out + noise.to(wide) * float(_F(s_noise) * su[i])
        return (out, (denoised, True), nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (torch.zeros_like(x), False), st.noise_state,
                     callback=callback, method=method, resume_from=resume_from,
                     start_step=start_step, stop_step=stop_step, return_state=return_state)


@sharded
def sample_res_multistep(model, x, sigmas, *, eta=0.0, **kw):
    """ComfyUI ``sample_res_multistep`` (deterministic: eta=0)."""
    return _res_multistep(model, x, sigmas, eta=eta, **kw)


@sharded
def sample_res_multistep_ancestral(model, x, sigmas, *, eta=1.0, **kw):
    """ComfyUI ``sample_res_multistep_ancestral`` (eta=1 default)."""
    return _res_multistep(model, x, sigmas, eta=eta, **kw)


# SonarPipeline forwards its noise/eta/s_noise defaults only to samplers whose
# signatures declare them; a bare **kw wrapper reads as "accepts everything".
# Expose the wrapped signature (inspect.signature follows __wrapped__).
sample_res_multistep.__wrapped__ = _res_multistep
sample_res_multistep_ancestral.__wrapped__ = _res_multistep


@sharded
def sample_ddpm(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """ComfyUI ``sample_ddpm`` (generic_step_sampler + DDPMSampler_step): the
    ancestral DDPM posterior step in VP space, driven from the EDM sigma
    schedule by ``alpha_cumprod = 1/(sigma^2 + 1)``. Draws only where
    ``sigma_next > 0`` (the reference's guard)."""
    st, sig = _kd_setup(model, x, sigmas, default_noise_type="gaussian", noise_item=noise_item,
                        noise_sampler=noise_sampler, seed=seed, extra_args=extra_args,
                        need_noise=True)
    wide = _wide(x)
    one = _F(1.0)

    def step_fn(carry, i):
        xc, aux, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, float(sigma))
        xw = xc.to(wide)
        eps = (xw - denoised.to(wide)) / float(sigma)
        x_vp = xw / float(np.sqrt(one + sigma**2))
        ac, ac_prev = one / (sigma**2 + one), one / (sigma_next**2 + one)
        alpha = ac / ac_prev
        out = (x_vp - eps * float(one - alpha) / float(np.sqrt(one - ac))) \
            * float(np.sqrt(one / alpha))
        if sigma_next > 0:
            noise, nstate = st.noise_fn(nstate, i, float(sigma), float(sigma_next))
            post_std = np.sqrt(np.maximum((one - alpha) * (one - ac_prev) / (one - ac), _F(0)))
            out = out + (noise * s_noise).to(wide) * float(post_std)
            out = out * float(np.sqrt(one + sigma_next**2))
        return (out, aux, nstate), _info(out, sigma, sigma, denoised)

    return _run_loop(step_fn, x, len(sig) - 1, (), st.noise_state, callback=callback,
                     method=method, resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


KDIFFUSION_SAMPLERS = {
    "euler": sample_euler,
    "euler_ancestral": sample_euler_ancestral,
    "heun": sample_heun,
    "heunpp2": sample_heunpp2,
    "dpm_2": sample_dpm_2,
    "dpm_2_ancestral": sample_dpm_2_ancestral,
    "dpmpp_2m": sample_dpmpp_2m,
    "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "dpmpp_sde": sample_dpmpp_sde,
    "dpmpp_sde_gpu": sample_dpmpp_sde,  # ComfyUI's _gpu names: the same math
    "dpmpp_2m_sde": sample_dpmpp_2m_sde,  # (a torch noise-device detail there)
    "dpmpp_2m_sde_gpu": sample_dpmpp_2m_sde,
    "dpmpp_3m_sde": sample_dpmpp_3m_sde,
    "dpmpp_3m_sde_gpu": sample_dpmpp_3m_sde,
    "ddim": sample_ddim,
    "ddpm": sample_ddpm,
    "lcm": sample_lcm,
    "res_multistep": sample_res_multistep,
    "res_multistep_ancestral": sample_res_multistep_ancestral,
}

# the coefficient-table multistep family (deis/lms/ipndm/ipndm_v/uni_pc) and
# the DPM-Solver fast/adaptive pair live in their own modules; they register
# here so every common ComfyUI name resolves
from .dpm_solver import DPM_SOLVER_SAMPLERS  # noqa: E402
from .multistep import MULTISTEP_SAMPLERS  # noqa: E402

KDIFFUSION_SAMPLERS.update(MULTISTEP_SAMPLERS)
KDIFFUSION_SAMPLERS.update(DPM_SOLVER_SAMPLERS)
