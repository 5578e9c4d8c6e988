"""k-diffusion step primitives (semantics of comfy.k_diffusion.sampling).

Sigmas may be numbers or tensors; the splits compute in float32 tensors, as
the JAX package does, so both give the same rounded values.
"""

from __future__ import annotations

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def to_d(x, sigma, denoised):
    """Convert a denoised prediction to the ODE derivative d = (x - D)/sigma."""
    return (x - denoised) / sigma


def get_ancestral_step(sigma, sigma_next, eta: float = 1.0):
    """Ancestral split of a step into (sigma_down, sigma_up).

    sigma_up = min(sigma_next, eta * sqrt(sigma_next^2 (sigma^2 - sigma_next^2) / sigma^2))
    sigma_down = sqrt(sigma_next^2 - sigma_up^2)
    """
    sigma, sigma_next = _f32(sigma), _f32(sigma_next)
    if not eta:
        return sigma_next, torch.zeros_like(sigma_next)
    sigma_up = torch.minimum(
        sigma_next,
        eta * torch.sqrt(sigma_next**2 * (sigma**2 - sigma_next**2) / sigma**2),
    )
    sigma_down = torch.sqrt(sigma_next**2 - sigma_up**2)
    return sigma_down, sigma_up


def get_ancestral_step_rf(sigma, sigma_next, eta: float = 1.0):
    """Rectified-flow ancestral split → (sigma_down, sigma_up, alpha_ratio).

    For flow models sigma is the interpolation time of
    ``x = (1-sigma)*x0 + sigma*noise``: the step goes to ``sigma_down =
    sigma_next * (1 + (sigma_next/sigma - 1) * eta)``, rescales the latent
    by ``alpha_ratio = (1-sigma_next)/(1-sigma_down)`` and re-injects
    ``sigma_up = sqrt(sigma_next^2 - sigma_down^2 * alpha_ratio^2)`` of fresh
    noise. eta=0 reduces to (sigma_next, 0, 1). An ascending pair clamps to
    the deterministic step; see the JAX package for the derivation."""
    sigma, sigma_next = _f32(sigma), _f32(sigma_next)
    if not eta:
        return sigma_next, torch.zeros_like(sigma_next), torch.ones_like(sigma_next)
    ratio = 1.0 + (sigma_next / sigma - 1.0) * eta
    sigma_down = torch.minimum(torch.clamp(sigma_next * ratio, min=0.0), sigma_next)
    alpha_down = torch.clamp(1.0 - sigma_down, min=1e-10)
    alpha_ratio = (1.0 - sigma_next) / alpha_down
    sigma_up = torch.sqrt(
        torch.clamp(sigma_next**2 - sigma_down**2 * alpha_ratio**2, min=0.0))
    return sigma_down, sigma_up, alpha_ratio
