"""Reference-latent guidance (port of ``sonar_tpu.samplers.guidance``,
reference py/sonar.py:323-411). Sigmas and the step are host numbers here,
so the window and the degenerate-step fallback are Python branches."""

from __future__ import annotations

import torch

from ..core.normalize import tstd
from .ancestral import to_d
from .momentum import GuidanceConfig, GuidanceType, SonarConfig


def prepare_ref_latent(latent, *, strict_reference_compat: bool = False):
    """Per-(H,W) standardize (py/sonar.py:335-341). Zero-std guard: a
    constant guide latent degrades to the mean-subtracted latent instead of
    the reference's NaN; ``strict_reference_compat=True`` keeps the
    reference's raw division (a NaN trajectory for a constant guide)."""
    if latent is None:
        return None
    avg = latent.mean(dim=(-2, -1), keepdim=True)
    std = tstd(latent, dim=(-2, -1), keepdim=True)
    if strict_reference_compat:
        return (latent - avg) / std
    return (latent - avg) / torch.where(std == 0, torch.ones_like(std), std)


def guidance_shift(t, ref_latent, *, dim=None):
    """ref·std(t) + mean(t) over all-but-batch dims (py/sonar.py:371-377)."""
    if dim is None:
        dim = tuple(range(-(t.ndim - 1), 0))
    avg_t = t.mean(dim=dim, keepdim=True)
    std_t = tstd(t, dim=dim, keepdim=True)
    return ref_latent * std_t + avg_t


def guidance_linear(x, ref_latent, factor=0.2, *, blend, do_shift: bool = True):
    ref_shift = guidance_shift(x, ref_latent) if do_shift else ref_latent
    return blend(x, ref_shift, factor)


def guidance_euler(sigma, sigma_next, x, denoised, ref_latent, factor=0.2, *,
                   blend, do_shift: bool = True):
    """Euler step toward the shifted reference (py/sonar.py:379-398); a
    degenerate sigma == sigma_next falls back to linear guidance with plain
    lerp, as the reference does (its EULER path never forwards the blend)."""
    del blend
    if sigma == sigma_next:
        return guidance_linear(x, ref_latent, factor=factor,
                               blend=lambda a, b, t: a + (b - a) * t,
                               do_shift=do_shift)
    ref_shift = guidance_shift(denoised, ref_latent) if do_shift else ref_latent
    d = to_d(x, 1.0 if sigma == 0 else sigma, ref_shift)
    dt = (sigma_next - sigma) * factor
    return d * dt + x


def guidance_step(cfg: SonarConfig, step: int, x, denoised, sigma, sigma_next,
                  ref_latent):
    """Step-window-gated guidance (py/sonar.py:343-369). ``ref_latent``
    must already be prepared by :func:`prepare_ref_latent`."""
    g: GuidanceConfig | None = cfg.guidance
    if g is None or g.factor == 0.0 or ref_latent is None:
        return x
    if not (g.start_step <= step <= g.end_step):
        return x
    if g.guidance_type == GuidanceType.LINEAR:
        return guidance_linear(x, ref_latent, g.factor, blend=cfg.guidance_blend)
    if g.guidance_type == GuidanceType.EULER:
        return guidance_euler(sigma, sigma_next, x, denoised, ref_latent, g.factor,
                              blend=cfg.guidance_blend)
    raise ValueError("Sonar: Guidance: Unknown guidance type")
