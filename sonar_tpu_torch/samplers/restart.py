"""Restart sampling with custom noise (port of ``sonar_tpu.samplers.restart``;
the capability the reference gets from the external ``restart_sampling``
pack, py/nodes/integrations.py:184-288: KRestartSamplerCustomNoise and
RestartSamplerCustomNoise exist to let that pack draw its restart noise from
a Sonar custom-noise chain).

Algorithm (Xu et al. 2023, "Restart Sampling for Improving Generative
Processes"): sample down the base schedule; at configured segments
``[t_min, t_max]``, repeat K times: jump back up by adding fresh noise
``x += noise · sqrt(t_max² − t_min²)`` and re-sample the segment with an
n-step schedule. The jump noise comes from any :class:`NoiseItem` tree, or
from the Philox gaussian stream (kernel B3) of a seed derived per jump; each
inner sampler call gets its own derived seed.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.rng import derive_seed, seed_from
from ..kernels.hwrng import philox_randn
from ..noise.base import NoiseItem, make_noise_sampler
from .schedules import karras_ramp
from .sonar import _host_sigmas, current_shard, sample_sonar_euler, sharded


@dataclasses.dataclass(frozen=True)
class RestartSegment:
    """One restart window: K jumps from t_min back to t_max, each re-sampled
    with an n-step Karras sub-schedule."""

    t_min: float
    t_max: float
    n: int = 4
    k: int = 2


def restart_schedule(n: int, t_min: float, t_max: float) -> np.ndarray:
    """The n-step Karras ladder from t_max down to t_min for one restart
    repeat: n+1 strictly descending sigmas (n model evaluations)."""
    sched = karras_ramp(n + 1, max(t_min, 1e-4), t_max)
    if not np.all(np.diff(sched) < 0):
        raise ValueError(
            f"degenerate restart schedule for n={n}, t_min={t_min}, t_max={t_max}")
    return sched


def default_segments(sigmas, *, n_restarts: int = 1, segment_steps: int = 4,
                     k_repeats: int = 2) -> tuple[RestartSegment, ...]:
    """Place restarts at the geometric midpoints of the schedule."""
    s = _host_sigmas(sigmas).numpy().astype(np.float64)
    s = s[s > 0]
    out = []
    for i in range(n_restarts):
        frac = (i + 1) / (n_restarts + 1)
        t_min = float(np.exp(np.log(s[-1]) + frac * (np.log(s[0]) - np.log(s[-1]))))
        t_max = min(float(s[0]), t_min * 3.0)
        out.append(RestartSegment(t_min=t_min, t_max=t_max, n=segment_steps, k=k_repeats))
    return tuple(out)


@sharded
def sample_restart(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    *,
    segments: Sequence[RestartSegment] | None = None,
    inner_sampler: Callable | None = None,
    custom_noise: NoiseItem | None = None,
    s_noise: float = 1.0,
    seed: int | None = None,
    **sampler_kwargs,
) -> torch.Tensor:
    """Run ``inner_sampler`` (default sonar_euler) over ``sigmas`` with restart
    segments whose jump noise comes from ``custom_noise``."""
    sigmas = _host_sigmas(sigmas).numpy()
    inner = inner_sampler if inner_sampler is not None else sample_sonar_euler
    if segments is None:
        segments = default_segments(sigmas)
    # the base-pass walk stops at each segment's t_min crossing in schedule
    # order, so segments run by descending t_min
    segments = sorted(segments, key=lambda sg: -sg.t_min)
    # a seed in extra_args would override every inner call's derived seed
    # (each restart repeat would reuse one noise stream): it becomes the base
    user_extra = dict(sampler_kwargs.pop("extra_args", None) or {})
    extra_seed = user_extra.pop("seed", None)
    if user_extra:
        sampler_kwargs["extra_args"] = user_extra
    base = seed_from(seed if seed is not None else extra_seed)

    pos = sigmas[sigmas > 0]
    sigma_min_all = float(pos.min()) if pos.size else 0.0
    sigma_max_all = float(sigmas.max())
    noise_fn = noise_state = None
    # on a shard, the jumps' noise is this rank's block of the whole latent's
    shard = current_shard()
    shape = tuple(x.shape if shard is None else shard.global_shape)
    if custom_noise is not None:
        noise_fn, noise_state = make_noise_sampler(
            custom_noise, shape, dtype=x.dtype, device=x.device,
            sigma_min=sigma_min_all, sigma_max=sigma_max_all,
            seed=derive_seed(base, "restart"), normalized=True, ref_latent=x, shard=shard)
    block = {} if shard is None else {"shard": shard.runs(*shape[-2:])}

    def draw(state, t0, t1, idx):
        if noise_fn is None:
            return (philox_randn(derive_seed(base, "gauss", idx), tuple(x.shape),
                                 device=x.device, dtype=x.dtype, **block), state)
        return noise_fn(state, float(np.float32(t0)), float(np.float32(t1)))

    inner_calls = 0

    def run_inner(cur, sched):
        nonlocal inner_calls
        inner_calls += 1
        return inner(model, cur, torch.from_numpy(np.asarray(sched, np.float32)),
                     seed=derive_seed(base, "inner", inner_calls), **sampler_kwargs)

    # base pass over the full schedule, interrupted at each segment's t_min
    cur = x
    draw_idx = 0
    sched = list(sigmas)
    start = 0
    for sg in segments:
        # the first index where sigma crosses below t_min; never the final
        # entry (a t_min on the trailing 0 would skip the final denoise step)
        idxs = [i for i, s in enumerate(sched) if s <= sg.t_min and start < i < len(sched) - 1]
        if not idxs:
            warnings.warn(
                f"restart segment (t_min={sg.t_min}, t_max={sg.t_max}) never fires: no "
                f"schedule sigma in ({sched[start]:.4g}, {sched[-1]:.4g}] crosses below "
                "t_min before the final entry; segment skipped", stacklevel=2)
            continue
        stop = idxs[0]
        seg_sched = np.asarray(sched[start:stop + 1], np.float32)
        if seg_sched.shape[0] >= 2:
            cur = run_inner(cur, seg_sched)
        t_min = float(sched[stop])
        t_max = min(sg.t_max, sigma_max_all)
        jump_std = math.sqrt(max(t_max**2 - t_min**2, 0.0))
        restart_sched = restart_schedule(sg.n, t_min, t_max)
        for _rep in range(sg.k):
            # (sigma, sigma') = (t_max, t_min): the jump noise belongs to the
            # top of the segment (an ascending pair would NaN items that take
            # an ancestral step from the sigmas)
            noise, noise_state = draw(noise_state, t_max, t_min, draw_idx)
            draw_idx += 1
            cur = cur + noise * (s_noise * jump_std)
            cur = run_inner(cur, restart_sched)
        start = stop
    tail = np.asarray(sched[start:], np.float32)
    if tail.shape[0] >= 2:
        cur = run_inner(cur, tail)
    return cur
