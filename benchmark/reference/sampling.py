"""What the reference samplers and noises share: the ancestral split of a
step (VP, and rectified flow's), ``scale_noise``, and the seed chain that
gives each draw its stream.

Written from the semantics of ComfyUI-sonar (py/sonar.py, py/utils.py:85-106)
as the JAX package states them, in float32 PyTorch on whatever device the
tensors are on, one operation at a time and without kernels. Nothing here
imports the program.
"""

from __future__ import annotations

import math

import torch

from . import philox


def ancestral_split(sigma: float, sigma_next: float, eta: float = 1.0):
    """(sigma_down, sigma_up) of one ancestral step, in float32."""
    s, sn = torch.tensor(sigma, dtype=torch.float32), torch.tensor(sigma_next, dtype=torch.float32)
    if not eta:
        return float(sn), 0.0
    up = torch.minimum(sn, eta * torch.sqrt(sn**2 * (s**2 - sn**2) / s**2))
    down = torch.sqrt(sn**2 - up**2)
    return float(down), float(up)


def ancestral_split_rf(sigma: float, sigma_next: float, eta: float = 1.0):
    """(sigma_down, sigma_up, alpha) of one rectified-flow ancestral step,
    in float32, from ComfyUI's ``sample_euler_ancestral_RF``: the step goes
    to ``σ_down = σ_next·(1 + (σ_next/σ − 1)·η)``, then
    ``x ← α·x_down + noise·s_noise·σ_up`` with ``α = (1 − σ_next)/(1 − σ_down)``
    and ``σ_up = √(σ_next² − σ_down²·α²)``."""
    s, sn = torch.tensor(sigma, dtype=torch.float32), torch.tensor(sigma_next, dtype=torch.float32)
    if not eta:
        return float(sn), 0.0, 1.0
    down = sn * (1.0 + (sn / s - 1.0) * eta)
    alpha = (1.0 - sn) / (1.0 - down)
    up = torch.sqrt(sn**2 - down**2 * alpha**2)
    return float(down), float(up), float(alpha)


def scale_noise(noise: torch.Tensor, threshold_std_devs: float = 2.5) -> torch.Tensor:
    """Mean 0 and std 1, each applied only where the draw misses it by more
    than ``threshold_std_devs/√N`` (the std is ddof=1, taken before the mean
    is removed)."""
    n = noise.numel()
    mean = noise.mean()
    std = noise.std(correction=1)
    threshold = threshold_std_devs / math.sqrt(n)
    if abs(float(mean)) > threshold:
        noise = noise - mean
    if abs(1.0 - float(std)) > threshold and float(std) != 0.0:
        noise = noise / std
    return noise


def draw_seed(seed: int, step: int) -> int:
    """The seed of draw ``step`` of a sampler run given ``seed``: the run's
    stream seed from the user seed, the noise stream's from it, then one a
    draw."""
    stream = philox.seed_from(philox.derive_seed(philox.seed_from(seed), "noise"))
    return philox.derive_seed(stream, step)
