"""Model-sampling protocol (port of ``sonar_tpu.cfg.model_sampling``): the
surface wavelet CFG, the latent-op guider and the schedules need from the
host (ComfyUI's ``model.model_sampling``): ``sigma_min``, ``sigma_max``,
``timestep(sigma) -> [0, 999]`` and ``percent_to_sigma``.

``timestep`` has two forms. Given a host number or a numpy array it
returns numpy float32 (the host form: wavelet CFG computes its
percentages on the host, so no guided call reads the card). Given a tensor
it returns a float32 tensor on the tensor's device. Both follow the JAX
package's float32 arithmetic: ``DiscreteSampling.timestep`` is a float32
interpolation in log-sigma, and it feeds every wavelet-CFG percentage.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def make_beta_sigmas(n: int = 1000, beta_start: float = 0.00085,
                     beta_end: float = 0.012) -> np.ndarray:
    """Standard scaled-linear DDPM sigma table (SD1.x/SDXL)."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, n) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def _interp_torch(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``np.interp`` on tensors (ascending ``xp``, ends clamped)."""
    idx = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[idx - 1], xp[idx], fp[idx - 1], fp[idx]
    out = f0 + (x - x0) * (f1 - f0) / (x1 - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], out))


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteSampling:
    sigmas: np.ndarray = dataclasses.field(default_factory=make_beta_sigmas)
    # the table on each device it was asked for, made once
    _tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def _table(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The log-sigma table and its indices on ``device``."""
        key = str(device)
        if key not in self._tables:
            logs = np.log(np.asarray(self.sigmas, np.float32))
            self._tables[key] = (torch.from_numpy(logs).to(device),
                                 torch.arange(len(logs), dtype=torch.float32, device=device))
        return self._tables[key]

    def timestep(self, sigma):
        """Fractional index of ``sigma`` in the (ascending) table,
        piecewise-linear in log-sigma, in float32."""
        if isinstance(sigma, torch.Tensor):
            logs, idx = self._table(sigma.device)
            return _interp_torch(torch.log(torch.clamp(sigma.float(), min=1e-10)), logs, idx)
        logs = np.log(np.asarray(self.sigmas, np.float32))
        log_sigma = np.log(np.maximum(np.asarray(sigma, np.float32), np.float32(1e-10)))
        return np.float32(np.interp(log_sigma, logs, np.arange(len(logs), dtype=np.float32)))

    def percent_to_sigma(self, percent: float) -> float:
        """ComfyUI's percent→sigma (1.0 = sigma_min end, 0.0 = sigma_max)."""
        if percent <= 0.0:
            return 999999999.9
        if percent >= 1.0:
            return 0.0
        last = len(self.sigmas) - 1
        ts = round((1.0 - percent) * last)
        return float(self.sigmas[max(0, min(last, ts))])


@dataclasses.dataclass(frozen=True)
class ContinuousEDM:
    sigma_min_val: float = 0.002
    sigma_max_val: float = 120.0

    @property
    def sigma_min(self) -> float:
        return self.sigma_min_val

    @property
    def sigma_max(self) -> float:
        return self.sigma_max_val

    def timestep(self, sigma):
        lo, hi = np.log(self.sigma_min_val), np.log(self.sigma_max_val)
        if isinstance(sigma, torch.Tensor):
            pct = (torch.log(torch.clamp(sigma.float(), min=1e-10)) - lo) / (hi - lo)
            return torch.clamp(pct, 0.0, 1.0) * 999.0
        s = np.maximum(np.asarray(sigma, np.float32), np.float32(1e-10))
        pct = (np.log(s) - np.float32(lo)) / np.float32(hi - lo)
        return np.clip(pct, np.float32(0), np.float32(1)) * np.float32(999.0)

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 999999999.9
        if percent >= 1.0:
            return 0.0
        lo, hi = np.log(self.sigma_min_val), np.log(self.sigma_max_val)
        return float(np.exp(hi + (lo - hi) * percent))


def max_denoise(model_sampling, sigma0) -> bool:
    """ComfyUI's max-denoise rule (reference misc.py:99-106): the entry
    sigma counts as "full denoise" when it reaches the model's sigma_max
    within 1e-5 relative tolerance, or exceeds it. Shared by
    ``api.functions.noisy_latent_like`` and ``SonarPipeline.prepare_latent``."""
    m = float(model_sampling.sigma_max)
    s0 = float(sigma0)
    return math.isclose(m, s0, rel_tol=1e-05) or s0 > m


def time_snr_shift(alpha: float, t):
    """Resolution-shifted flow time: ``alpha*t / (1 + (alpha-1)*t)`` (the
    SD3/Flux timestep shift). Works on numbers, arrays and tensors."""
    if alpha == 1.0:
        return t
    return alpha * t / (1 + (alpha - 1) * t)


@dataclasses.dataclass(frozen=True)
class Flow:
    """Rectified-flow model sampling (SD3/Flux family): sigma is flow time,
    ``sigma_max = 1``, the network is conditioned on ``sigma * multiplier``,
    and ``shift`` applies the resolution shift to the per-timestep table
    and to percent windows."""

    shift: float = 1.0
    multiplier: float = 1000.0
    timesteps: int = 1000

    @property
    def sigmas(self) -> np.ndarray:
        t = np.arange(1, self.timesteps + 1, dtype=np.float64) / self.timesteps
        return np.asarray(time_snr_shift(self.shift, t), np.float32)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def timestep(self, sigma):
        if isinstance(sigma, torch.Tensor):
            return sigma.float() * self.multiplier
        return np.asarray(sigma, np.float32) * np.float32(self.multiplier)

    def sigma(self, timestep):
        if isinstance(timestep, torch.Tensor):
            return time_snr_shift(self.shift, timestep.float() / self.multiplier)
        return time_snr_shift(self.shift,
                              np.asarray(timestep, np.float32) / np.float32(self.multiplier))

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 1.0
        if percent >= 1.0:
            return 0.0
        return float(time_snr_shift(self.shift, 1.0 - percent))
