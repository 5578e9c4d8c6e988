"""High-level user API (port of ``sonar_tpu.api.functions``): the functional
equivalents of the reference's utility nodes (py/nodes/misc.py):
``noisy_latent_like``, ``noise_image``, the sampler registry, the sampler
config override and ``split_noise_chain``.

The registry holds the JAX package's 31 names: the three sonar samplers,
``restart`` and the k-diffusion set (with its multistep tables and the
DPM-Solver fast/adaptive pair).
"""

from __future__ import annotations

import inspect
import math
from typing import Callable

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..core.normalize import normalize_to_scale, scale_noise
from ..noise.base import NoiseItem, make_noise_sampler
from ..noise.chain import NoiseChain
from ..noise.presets import get_noise_item


def noisy_latent_like(
    latent: torch.Tensor,
    *,
    noise_type: str = "gaussian",
    seed: int | None = None,
    multiplier: float = 1.0,
    add_to_latent: bool = False,
    repeat_batch: int = 1,
    normalize: bool = True,
    custom_noise: NoiseItem | None = None,
    mul_by_sigmas=None,
    model_sampling=None,
    latent_scale_factor: float = 1.0,
) -> torch.Tensor:
    """Generate (and optionally add) noise shaped like ``latent`` on its
    device (reference: NoisyLatentLikeNode.go, py/nodes/misc.py:72-155).

    ``mul_by_sigmas`` + ``model_sampling`` reproduce the sigma-strength math
    incl. the max-denoise ``sqrt(1+sigma0^2)`` rule (misc.py:88-113);
    ``latent_scale_factor`` is the latent format's scale factor. The sigmas
    are read on the host."""
    sigmas = None if mul_by_sigmas is None else np.asarray(
        torch.as_tensor(mul_by_sigmas).detach().cpu(), np.float32).reshape(-1)
    if sigmas is not None and sigmas.shape[0] > 0:
        if model_sampling is None:
            raise ValueError("noisy_latent_like requires model_sampling when sigmas are passed!")
        from ..cfg.model_sampling import max_denoise

        first_sigma = float(sigmas[0])
        strength = (math.sqrt(1.0 + first_sigma**2)
                    if max_denoise(model_sampling, first_sigma) else first_sigma)
        multiplier *= strength / latent_scale_factor
    if sigmas is not None and sigmas.size > 1:
        pos = sigmas[sigmas > 0]
        sigma_min = float(pos.min()) if pos.size else None
        sigma_max = float(sigmas.max())
        sigma, sigma_next = float(sigmas[0]), float(sigmas[1])
    else:
        sigma_min = sigma_max = sigma = sigma_next = None
    item = custom_noise if custom_noise is not None else get_noise_item(noise_type)
    fn, state = make_noise_sampler(
        item, tuple(latent.shape), dtype=latent.dtype, device=latent.device, seed=seed,
        sigma_min=sigma_min, sigma_max=sigma_max, normalized=normalize, ref_latent=latent)
    draws = []
    for _ in range(repeat_batch):
        noise, state = fn(state, sigma, sigma_next)
        draws.append(noise)
    result = scale_noise(torch.cat(draws, dim=0), multiplier, normalized=True)
    if add_to_latent:
        result = result + latent.repeat((repeat_batch,) + (1,) * (latent.ndim - 1))
    return result


# channel indices; the reference swaps B and G (py/nodes/misc.py:284) —
# kept under strict_reference_compat.
_CHANNEL_MAP_REFERENCE = {"R": 0, "B": 1, "G": 2, "A": 3}
_CHANNEL_MAP_FIXED = {"R": 0, "G": 1, "B": 2, "A": 3}


def noise_image(
    image: torch.Tensor,
    *,
    noise_type: str = "gaussian",
    seed: int = 0,
    noise_multiplier: float = 0.5,
    noise_min: float = 0.0,
    noise_max: float = 1.0,
    channel_mode: str = "RGB",
    blend_mode: str = "simple_add",
    blend_strength: float = 0.5,
    overflow_mode: str = "clamp",
    greyscale_mode: bool = False,
    pure_noise_mode: bool = False,
    normalize: bool = True,
    custom_noise: NoiseItem | None = None,
    strict_reference_compat: bool = True,
) -> torch.Tensor:
    """Add noise to an (..., H, W, C) image or generate pure-noise images
    on its device (reference: SonarNoiseImageNode.go, py/nodes/misc.py:246-357)."""
    orig_shape = image.shape
    if pure_noise_mode:
        image = torch.zeros_like(image)
    if image.ndim == 3:
        image = image[None]
    elif image.ndim != 4:
        raise ValueError(f"Expected image tensor with 3 or 4 dimensions, got {image.ndim}")
    blend_function = (BLENDING_MODES[blend_mode] if blend_mode != "simple_add"
                      else (lambda a, b, _t: a + b))
    if noise_min > noise_max:
        noise_min, noise_max = noise_max, noise_min
    x = torch.movedim(image, -1, 1)
    channels = x.shape[1]
    cmap = _CHANNEL_MAP_REFERENCE if strict_reference_compat else _CHANNEL_MAP_FIXED
    if channels in (3, 4):
        targets = [cmap[c] for c in "RGBA" if c in channel_mode.upper() and cmap[c] < channels]
    else:
        targets = list(range(channels))
    item = custom_noise if custom_noise is not None else get_noise_item(noise_type)
    fn, state = make_noise_sampler(item, tuple(x.shape), dtype=x.dtype, device=x.device,
                                   seed=seed, normalized=normalize, ref_latent=x)
    result, _ = fn(state, None, None)
    result = scale_noise(result, normalized=True)
    if greyscale_mode:
        result = result.mean(dim=1, keepdim=True).expand(x.shape)
    if noise_max != 0 and noise_min != noise_max:
        # default per-batch-item dims, as misc.py:339 calls it
        result = normalize_to_scale(result, noise_min, noise_max)
    result = result * noise_multiplier
    if targets:  # e.g. channel_mode="A" on RGB selects nothing (misc.py:289)
        x = x.clone()
        x[:, targets] = blend_function(x[:, targets], result[:, targets], blend_strength)
    if overflow_mode == "rescale":
        x = normalize_to_scale(x, 0.0, 1.0)
    else:
        x = torch.clamp(x, 0.0, 1.0)
    return torch.movedim(x, 1, -1).reshape(orig_shape)


def split_noise_chain(chain: NoiseItem, split_index: int = 1):
    """Cut a chain at ``split_index`` into two rescaled chains (a framework
    extension; the reference's SonarSplitNoiseChain node, py/nodes/misc.py:
    628-664, does something different)."""
    items = chain.items if isinstance(chain, NoiseChain) else [chain]
    first = NoiseChain([i.clone() for i in items[:split_index]])
    second = NoiseChain([i.clone() for i in items[split_index:]])
    return tuple(c.rescaled(1.0) if c.items else None for c in (first, second))


# ---------------------------------------------------------------------------
# Sampler registry and config override (py/sonar.py:823-847 and
# SamplerConfigOverride, py/nodes/misc.py:461-625)
# ---------------------------------------------------------------------------

SAMPLERS: dict[str, Callable] = {}


def register_sampler(name: str, fn: Callable) -> None:
    SAMPLERS[name] = fn


def get_sampler(name: str) -> Callable:
    try:
        return SAMPLERS[name]
    except KeyError:
        valid = ", ".join(sorted(SAMPLERS))
        raise ValueError(f"Unknown sampler {name!r}; valid: {valid}") from None


def _register_builtin_samplers():
    from ..samplers.kdiffusion import KDIFFUSION_SAMPLERS
    from ..samplers.restart import sample_restart
    from ..samplers.sonar import (sample_sonar_dpmpp_sde, sample_sonar_euler,
                                  sample_sonar_euler_ancestral)

    register_sampler("sonar_euler", sample_sonar_euler)
    register_sampler("sonar_euler_ancestral", sample_sonar_euler_ancestral)
    register_sampler("sonar_dpmpp_sde", sample_sonar_dpmpp_sde)
    register_sampler("restart", sample_restart)
    # the plain k-diffusion set under their ComfyUI names, so workflows that
    # sample with host samplers (KSamplerSelect -> SamplerConfigOverride) run
    for name, fn in KDIFFUSION_SAMPLERS.items():
        register_sampler(name, fn)


_register_builtin_samplers()


def sampler_config_override(sampler: Callable | str, *, noise_item: NoiseItem | None = None,
                            **overrides) -> Callable:
    """Wrap any registered sampler, overriding only the kwargs its signature
    accepts (SamplerConfigOverride's signature inspection,
    py/nodes/misc.py:567-625)."""
    fn = get_sampler(sampler) if isinstance(sampler, str) else sampler
    sig = inspect.signature(fn)
    accepts = {name for name, p in sig.parameters.items()
               if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)}
    has_var_kw = any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values())
    kept = {k: v for k, v in overrides.items() if has_var_kw or k in accepts}
    if noise_item is not None and (has_var_kw or "noise_item" in accepts):
        kept["noise_item"] = noise_item

    def wrapped(model, x, sigmas, **kwargs):
        return fn(model, x, sigmas, **{**kwargs, **kept})

    wrapped.__name__ = f"override_{getattr(fn, '__name__', 'sampler')}"
    return wrapped
