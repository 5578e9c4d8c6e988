"""Sonar momentum samplers (port of ``sonar_tpu.samplers.sonar``; reference
SonarEuler / SonarEulerAncestral, py/sonar.py:452-623).

The loop is a Python loop over steps. The sigma schedule becomes host
numbers once, in ``_setup``, so every per-step branch (momentum window,
guidance window, the sigma_next == 0 tail) is decided on the host and no
step waits for the card. The carry is ``(x, momentum_state, noise_state)``.

Model protocol: ``model(x, sigma_batch, **extra_args) -> denoised`` where
``sigma_batch`` has shape (B,) — the reference's ``model(x, sigma * s_in)``.
A model with the attribute ``takes_sigma_host = True`` also gets
``sigma_host=`` the step's sigma as a host float.

Noise injection: pass ``noise_item`` (a NoiseItem spec) or ``noise_sampler``
as a plain callable ``fn(step, sigma, sigma_next) -> noise`` (e.g. a
recorded stream for trajectory-equivalence tests).

Sharded latents: every sampler of the registry takes a ``DTensor`` latent
(``parallel.shard_latent``) through :func:`sharded`, and steps its local
shard. The model sees the local rows, kernel B1 runs on the shard, the noise
is this rank's block of the whole latent's draw, normalized with the whole
latent's statistics, and the result is a ``DTensor`` with the input's
placements. Every host decision of a step must come out the same on every
rank (an adaptive step's accept reads a norm summed over the ranks), or the
ranks would part ways and then wait for each other in a collective.

Type promotion: the per-step scalars are host floats, which follow the
latent's type, so a bfloat16 latent is stepped in bfloat16 (the JAX
package's float32 sigma arrays promote its step arithmetic to float32 and
cast the carry back); the model is conditioned on a float32 sigma batch on
both sides.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from ..core.rng import derive_seed, seed_from
from ..kernels.fused import fused_momentum_step, pack_momentum_scalars
from ..noise.base import NoiseItem, make_noise_sampler
from ..noise.presets import get_noise_item
from ..parallel.mesh import LatentShard
from ..utils.profiling import span
from .ancestral import get_ancestral_step, get_ancestral_step_rf
from .guidance import guidance_step, prepare_ref_latent
from .momentum import (
    HistoryType,
    MomentumMode,
    SonarConfig,
    check_step,
    get_momentum_d,
    get_momentum_denoised,
    init_momentum_state,
    momentum_step,
)


@dataclasses.dataclass
class _Setup:
    sigmas: list[float]  # host values of the float32 schedule
    model_fn: Callable
    noise_fn: Callable | None
    noise_state: Any
    rand_init: torch.Tensor | None
    ref_latent: torch.Tensor | None


# the shard of the sampler call in progress (a ``parallel.LatentShard``), or None
_SHARD: contextvars.ContextVar = contextvars.ContextVar("sampler_shard", default=None)


def current_shard():
    """Where the latent of the sampler call in progress lies (a
    ``parallel.LatentShard``), or None for a whole latent."""
    return _SHARD.get()


def _unshard(x):
    """``(local latent, shard, wrap)``: a DTensor latent's local block, where
    it lies (a ``parallel.LatentShard``) and a function that turns a result
    (or a ``(result, carry)`` pair) back into a DTensor laid out as ``x``;
    any other latent as it is, None and the identity."""
    if not isinstance(x, DTensor):
        return x, None, lambda out: out
    shard = LatentShard.of(x)

    def wrap(out):
        if isinstance(out, tuple):
            return (shard.rewrap(out[0], x), *out[1:])
        return shard.rewrap(out, x)

    # a latent replicated on every axis is whole on each rank: unsharded noise
    return x.to_local(), (shard if shard.groups else None), wrap


def sharded(sampler: Callable) -> Callable:
    """``sampler(model, x, sigmas, ...)`` that also takes a DTensor latent:
    it runs on the local block, with :func:`current_shard` saying where the
    block lies (``_setup`` draws the block's noise from it), and its result
    is a DTensor laid out as ``x``. A plain latent inside a sharded call (a
    sampler that calls another) keeps the call's shard."""

    @functools.wraps(sampler)
    def run(model, x, sigmas, *args, **kwargs):
        if not isinstance(x, DTensor):
            return sampler(model, x, sigmas, *args, **kwargs)
        local, shard, wrap = _unshard(x)
        token = _SHARD.set(shard)
        try:
            return wrap(sampler(model, local, sigmas, *args, **kwargs))
        finally:
            _SHARD.reset(token)

    return run


def _host_sigmas(sigmas) -> torch.Tensor:
    """The schedule as a float32 CPU tensor (one copy per run)."""
    return torch.as_tensor(sigmas).detach().to("cpu", torch.float32).reshape(-1)


def _setup(model, x, sigmas, *, cfg: SonarConfig, default_noise_type: str,
           noise_item, noise_sampler, seed, extra_args, need_noise: bool) -> _Setup:
    shard = current_shard()
    extra_args = dict(extra_args or {})
    seed = seed_from(extra_args.pop("seed", seed))
    s = _host_sigmas(sigmas)
    pos = s[s > 0]
    sigma_min = float(pos.min()) if pos.numel() else float("inf")
    sigma_max = float(s.max())

    # a model that takes the step's sigma as a host number beside the batch
    # (SonarPipeline's guided denoiser) gets it, so CFG-time host decisions
    # read nothing back from the card
    host_kw = getattr(model, "takes_sigma_host", False)

    def model_fn(xi, sigma, **kw):
        # float32 whatever the latent's type: JAX multiplies a float32 sigma
        # by ones of xi.dtype, which promotes, and the UNet is conditioned on
        # the unrounded sigma (bf16 would move 14.6 to 14.625)
        s_in = torch.full((xi.shape[0],), sigma, dtype=torch.float32, device=xi.device)
        if host_kw:
            kw = {**kw, "sigma_host": sigma}
        return model(xi, s_in, **extra_args, **kw)

    # Noise precedence: custom_noise > explicit sampler > typed default
    # (py/sonar.py:133-167). A shard draws its block of the whole latent's noise.
    shape = tuple(x.shape) if shard is None else tuple(shard.global_shape)
    noise_fn = noise_state = None
    if need_noise:
        item = cfg.custom_noise if cfg.custom_noise is not None else noise_item
        if item is None and noise_sampler is None:
            item = get_noise_item(cfg.noise_type or default_noise_type)
        if item is not None:
            fn, noise_state = make_noise_sampler(
                item, shape, dtype=x.dtype, device=x.device,
                sigma_min=sigma_min, sigma_max=sigma_max,
                seed=derive_seed(seed, "noise"), normalized=True, ref_latent=x,
                shard=shard,
            )

            def noise_fn(nstate, step, sigma, sigma_next):
                return fn(nstate, sigma, sigma_next)

        else:

            def noise_fn(nstate, step, sigma, sigma_next):
                return noise_sampler(step, sigma, sigma_next), nstate

            noise_state = ()

    rand_init = None
    if cfg.init == HistoryType.RAND:
        ri_fn, ri_state = make_noise_sampler(
            get_noise_item(cfg.rand_init_noise_type), shape, dtype=x.dtype,
            device=x.device, seed=derive_seed(seed, "rand_init"), normalized=True,
            ref_latent=x, shard=shard,
        )
        rand_init, _ = ri_fn(ri_state, None, None)

    ref_latent = prepare_ref_latent(cfg.guidance.latent) if cfg.guidance else None
    return _Setup(s.tolist(), model_fn, noise_fn, noise_state, rand_init, ref_latent)


def _restabilize(new, old):
    """Sampler math may promote; cast each tensor of the carry back to the
    dtype it had, so a bf16/f16 latent stays in its dtype."""
    if isinstance(new, torch.Tensor) and isinstance(old, torch.Tensor):
        return new.to(old.dtype) if new.dtype != old.dtype else new
    if isinstance(new, dict) and isinstance(old, dict):
        return {k: _restabilize(v, old.get(k)) for k, v in new.items()}
    if isinstance(new, tuple) and isinstance(old, tuple) and len(new) == len(old):
        return tuple(_restabilize(a, b) for a, b in zip(new, old))
    return new


def _check_method(method: str) -> None:
    """The JAX samplers run ``method="scan"`` as one ``lax.scan`` and
    ``"python"`` as a host loop; here both name the host loop, and anything
    else is refused with the JAX package's message."""
    if method not in ("scan", "python"):
        raise ValueError("method must be 'scan' or 'python'")


def _run_loop(step_fn, x, n_steps: int, mom_state, noise_state, *, callback=None,
              method: str = "scan", resume_from=None, start_step: int = 0,
              stop_step: int | None = None, return_state: bool = False):
    """Run steps [start_step, stop_step). Checkpoint/resume: the whole
    sampler state is the carry ``(x, momentum_state, noise_state)`` — run
    with ``stop_step=k, return_state=True`` to checkpoint, then
    ``resume_from=carry, start_step=k`` to continue; the result is bitwise
    identical to an uninterrupted run."""
    _check_method(method)
    stop = n_steps if stop_step is None else min(stop_step, n_steps)
    carry = resume_from if resume_from is not None else (x, mom_state, noise_state)
    for i in range(start_step, stop):
        with span("sonar.step"):
            new_carry, info = step_fn(carry, i)
            carry = _restabilize(new_carry, carry)
        if callback is not None:
            callback({"i": i, **info})
    return (carry[0], carry) if return_state else carry[0]


@sharded
def sample_sonar_euler(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    sonar_config: SonarConfig | None = None,
    sonar_params: dict | None = None,
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
    """Deterministic momentum Euler (py/sonar.py:452-526)."""
    cfg = (sonar_config or SonarConfig()).updated(sonar_params)
    st = _setup(model, x, sigmas, cfg=cfg, default_noise_type="gaussian",
                noise_item=None, noise_sampler=noise_sampler, seed=seed,
                extra_args=extra_args, need_noise=False)
    sig = st.sigmas

    def step_fn(carry, i):
        xc, mom, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, sigma)
        out, mom = momentum_step(cfg, mom, xc, denoised, sigma, sigma_next, step=i,
                                 rand_init=st.rand_init)
        if sigma_next > 0:
            out = guidance_step(cfg, i, out, denoised, sigma, sigma_next, st.ref_latent)
        return (out, mom, nstate), {"x": out, "sigma": sigma, "sigma_hat": sigma,
                                    "denoised": denoised}

    return _run_loop(step_fn, x, len(sig) - 1, init_momentum_state(x), (),
                     callback=callback, method=method, resume_from=resume_from,
                     start_step=start_step, stop_step=stop_step, return_state=return_state)


def _fused_eligible(cfg: SonarConfig) -> bool:
    """Kernel B1 covers the default config family: NEW mode, lerp blends,
    ZERO init, no guidance, static momentum != 1."""
    return (
        cfg.momentum_mode == MomentumMode.NEW
        and cfg.init == HistoryType.ZERO
        and cfg.guidance is None
        and (cfg.momentum_blend_mode or cfg.blend_mode) == "lerp"
        and (cfg.history_blend_mode or cfg.blend_mode) == "lerp"
        and isinstance(cfg.momentum, (int, float))
        and cfg.momentum != 1
        and cfg.momentum_hist != 1
    )


def _ancestral_schedule(sigmas: list[float], eta: float, s_noise: float, rf: bool):
    """Per-step float32 split of the schedule: sigma_down, sigma_up and
    alpha_ratio (or None) as host numbers, and sigma, dt = sigma_down - sigma
    and the injected noise scale (0 on the final step, py/sonar.py:303) as
    float32 vectors."""
    s = torch.tensor(sigmas, dtype=torch.float32)
    sigma, sigma_next = s[:-1], s[1:]
    if rf:
        sigma_down, sigma_up, alpha_ratio = get_ancestral_step_rf(sigma, sigma_next, eta)
        alpha_ratio = torch.broadcast_to(alpha_ratio, sigma.shape).tolist()
    else:
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta=eta)
        alpha_ratio = None
    sigma_down = torch.broadcast_to(sigma_down, sigma.shape)
    sigma_up = torch.broadcast_to(sigma_up, sigma.shape)
    noise_scale = torch.where(sigma_next > 0, s_noise * sigma_up,
                              torch.zeros_like(sigma_up))
    return {
        "sigma": sigma,
        "sigma_down": sigma_down.tolist(),
        "sigma_up": sigma_up.tolist(),
        "alpha_ratio": alpha_ratio,
        "dt": (sigma_down - sigma),
        "noise_scale": noise_scale,
    }


def _momentum_tables(cfg: SonarConfig, sched, device) -> torch.Tensor:
    """(2, steps, 10) kernel-B1 scalars, indexed [has, step]. ``has`` is the
    only column that depends on the carry; both variants are built here, in
    one copy to the card per run, so each step reads its row in place."""
    dt, noise_scale = sched["dt"], sched["noise_scale"]
    steps = dt.shape[0]
    hd_ratio, hd_scale, md_scale = cfg.history_ratios
    in_window = torch.tensor([check_step(cfg, i) for i in range(steps)])
    hist_window = torch.tensor([check_step(cfg, i, is_history=True) for i in range(steps)])
    return torch.stack([
        pack_momentum_scalars(
            sigma=sched["sigma"], dt=dt, momentum=cfg.momentum, hd_ratio=hd_ratio,
            hd_scale=hd_scale, md_scale=md_scale, has=has, noise_scale=noise_scale,
            in_window=in_window, hist_window=hist_window)
        for has in (False, True)
    ]).to(device)


@sharded
def sample_sonar_euler_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    sonar_config: SonarConfig | None = None,
    sonar_params: dict | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    noise_item: NoiseItem | None = None,
    noise_sampler: Callable | None = None,
    seed: int | None = None,
    extra_args: dict | None = None,
    callback=None,
    method: str = "scan",
    use_fused: bool | None = None,
    ancestral_mode: str = "vp",
    resume_from=None,
    start_step: int = 0,
    stop_step: int | None = None,
    return_state: bool = False,
) -> torch.Tensor:
    """Ancestral momentum Euler (py/sonar.py:529-623).

    ``use_fused=None`` routes the momentum chain and the noise injection
    through kernel B1 (:func:`~sonar_tpu_torch.kernels.fused.fused_momentum_step`)
    whenever the config qualifies (:func:`_fused_eligible`); on a CPU
    tensor that wrapper runs its plain version. ``use_fused=False`` selects
    the composed path.

    ``ancestral_mode="rf"`` uses the rectified-flow noise split for
    CONST/flow models (see :func:`get_ancestral_step_rf`); it always takes
    the composed path.

    On a DTensor latent the kernel B1 tables stay one per run.
    """
    if ancestral_mode not in ("vp", "rf"):
        raise ValueError(f"ancestral_mode must be 'vp' or 'rf', "
                         f"got {ancestral_mode!r}")
    rf = ancestral_mode == "rf"
    if use_fused and rf:
        raise ValueError(
            "use_fused=True is not supported with ancestral_mode='rf' "
            "(the fused momentum kernel bakes the VP noise injection); "
            "leave use_fused=None to auto-select the unfused path")
    cfg = (sonar_config or SonarConfig()).updated(sonar_params)
    st = _setup(model, x, sigmas, cfg=cfg, default_noise_type="gaussian",
                noise_item=noise_item, noise_sampler=noise_sampler, seed=seed,
                extra_args=extra_args, need_noise=True)
    sig = st.sigmas
    sched = _ancestral_schedule(sig, eta, s_noise, rf)
    fused = (use_fused is None or use_fused) and _fused_eligible(cfg) and not rf
    tables = _momentum_tables(cfg, sched, x.device) if fused else None
    noise_scale = sched["noise_scale"].tolist()

    def step_fn(carry, i):
        xc, mom, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = st.model_fn(xc, sigma)
        noise, nstate = st.noise_fn(nstate, i, sigma, sigma_next)
        info = {"sigma": sigma, "sigma_hat": sigma, "denoised": denoised}
        if fused:
            # the tail (sigma_next == 0) adds no noise, as the composed path
            # below: zeros in its place, so that a draw that is not finite
            # there (ModulatedNoise's 0/0 norm ratio at sigma_up == 0) does
            # not turn noise * 0 into NaN
            step_noise = noise if sigma_next > 0 else torch.zeros_like(noise)
            out, new_hd = fused_momentum_step(xc, denoised, mom["hd"], step_noise,
                                              tables[int(mom["has"]), i])
            mom = {"hd": new_hd,
                   "has": mom["has"] or check_step(cfg, i, is_history=True)}
            return (out, mom, nstate), {"x": out, **info}
        out, mom = momentum_step(cfg, mom, xc, denoised, sigma,
                                 sched["sigma_down"][i], step=i,
                                 rand_init=st.rand_init)
        if sigma_next > 0:
            out = guidance_step(cfg, i, out, denoised, sigma, sigma_next, st.ref_latent)
            if rf:
                out = out * sched["alpha_ratio"][i]
            out = out + noise * noise_scale[i]
        return (out, mom, nstate), {"x": out, **info}

    return _run_loop(step_fn, x, len(sig) - 1, init_momentum_state(x),
                     st.noise_state, callback=callback, method=method,
                     resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)


def _dpmpp_sde_schedule(sigmas: list[float], eta: float, s_noise: float, r: float):
    """The per-step scalars of the two-stage step as host numbers, computed
    in float32 over the whole schedule at once (py/sonar.py:640-735):
    ``s_t``/``s_s`` the sigmas of the step's start and of its midpoint
    ``t + r·h``; for each stage the multiplier of ``x``
    (``sigma_fn(t_down)/s_t``), the ``expm1(t - t_down)`` factor of the
    denoised and the injected noise scale ``s_noise·sigma_up``. The 1e-10
    floors keep the logarithms finite where a sigma_down is 0 (``eta = 1``,
    and the ``sigma_next == 0`` tail, whose stage values are not used)."""
    s = torch.tensor(sigmas, dtype=torch.float32)
    sigma, sigma_next = s[:-1], s[1:]
    t = -torch.log(sigma)
    h = -torch.log(sigma_next.clamp(min=1e-10)) - t
    s_t, s_s = torch.exp(-t), torch.exp(-(t + h * r))

    def stage(target):
        sd, su = get_ancestral_step(s_t, target, eta)
        t_down = -torch.log(torch.broadcast_to(sd, s_t.shape).clamp(min=1e-10))
        return {"x_scale": (torch.exp(-t_down) / s_t).tolist(),
                "expm1": torch.expm1(t - t_down).tolist(),
                "noise_scale": torch.broadcast_to(s_noise * su, s_t.shape).tolist()}

    return {"s_t": s_t.tolist(), "s_s": s_s.tolist(), "mid": stage(s_s),
            "end": stage(sigma_next)}


@sharded
def sample_sonar_dpmpp_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    sonar_config: SonarConfig | None = None,
    sonar_params: dict | None = None,
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
    """Two-stage DPM++ SDE with momentum injected twice per step
    (py/sonar.py:626-820). Default noise: brownian (py/sonar.py:627).

    Two model calls and two noise draws a step; the draws are indexed
    ``2i`` and ``2i + 1`` and take the sigma pairs ``(s_t, s_s)`` and
    ``(s_t, sigma_next)``. The ``sigma_next == 0`` tail runs the plain
    momentum step alone (one model call). The JAX package's scan computes
    both branches there and so makes the two draws as well, unused: the tail
    makes them too, so the noise state a run returns (the draw counter, a
    Brownian endpoint cache) is the one the JAX package's run returns."""
    cfg = (sonar_config or SonarConfig()).updated(sonar_params)
    st = _setup(model, x, sigmas, cfg=cfg, default_noise_type="brownian",
                noise_item=noise_item, noise_sampler=noise_sampler, seed=seed,
                extra_args=extra_args, need_noise=True)
    sig = st.sigmas
    sched = _dpmpp_sde_schedule(sig, eta, s_noise, r)
    fac = 1 / (2 * r)
    m = cfg.momentum
    # The JAX step multiplies by float32 sigmas, which promotes a bfloat16 or
    # float16 latent: the whole step runs in float32, the second model call
    # sees a float32 latent and the carry is rounded once a step. Here the
    # scalars are host numbers, which follow the tensor's type, so the step
    # widens what it reads; float32 is left as it is.
    wide = torch.promote_types(x.dtype, torch.float32)

    def step_fn(carry, i):
        xc, mom, nstate = carry
        sigma, sigma_next = sig[i], sig[i + 1]
        s_t, s_s = sched["s_t"][i], sched["s_s"][i]
        mid, end = sched["mid"], sched["end"]
        denoised = st.model_fn(xc, sigma)
        info = {"sigma": sigma, "sigma_hat": sigma, "denoised": denoised}
        xc, denoised = xc.to(wide), denoised.to(wide)
        if sigma_next == 0:
            # py/sonar.py:658-659; get_ancestral_step(sigma, 0) is (0, 0)
            out, mom = momentum_step(cfg, mom, xc, denoised, sigma, sigma_next, step=i,
                                     rand_init=st.rand_init)
            _, nstate = st.noise_fn(nstate, 2 * i, s_t, s_s)
            _, nstate = st.noise_fn(nstate, 2 * i + 1, s_t, sigma_next)
            return (out, mom, nstate), {"x": out, **info}

        # the reference halves the distance of the momentum to 1 once there
        # is history; get_momentum_d reads it only for its momentum == 1 gate
        adjusted = 1.0 if m == 1 else (m + (1 - m) / 2 if mom["has"] else m)
        kw = dict(step=i, rand_init=st.rand_init)
        momentum_denoised, mom = get_momentum_denoised(cfg, mom, xc, denoised, sigma, **kw)
        momentum_d, mom = get_momentum_d(
            cfg, mom, xc, momentum_denoised, sigma, momentum=adjusted,
            d=momentum_denoised * mid["expm1"][i], **kw)
        x_2 = xc * mid["x_scale"][i] - momentum_d
        noise1, nstate = st.noise_fn(nstate, 2 * i, s_t, s_s)
        x_2 = x_2 + noise1.to(wide) * mid["noise_scale"][i]
        denoised_2 = st.model_fn(x_2, s_s).to(wide)
        momentum_denoised_2, mom = get_momentum_denoised(cfg, mom, xc, denoised_2, s_s, **kw)

        denoised_d = momentum_denoised * (1 - fac) + momentum_denoised_2 * fac
        momentum_d, mom = get_momentum_d(
            cfg, mom, xc, momentum_denoised_2, s_s, momentum=adjusted,
            d=denoised_d * end["expm1"][i], **kw)
        out = xc * end["x_scale"][i] - momentum_d
        out = guidance_step(cfg, i, out, denoised_d, sigma, sigma_next, st.ref_latent)
        noise2, nstate = st.noise_fn(nstate, 2 * i + 1, s_t, sigma_next)
        out = out + noise2.to(wide) * end["noise_scale"][i]
        return (out, mom, nstate), {"x": out, **info}

    return _run_loop(step_fn, x, len(sig) - 1, init_momentum_state(x),
                     st.noise_state, callback=callback, method=method,
                     resume_from=resume_from, start_step=start_step,
                     stop_step=stop_step, return_state=return_state)
