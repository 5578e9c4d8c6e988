"""The ``basic`` pipeline's guided denoiser: eps preconditioning (the
network sees ``x/√(σ²+1)``, the denoised latent is ``x − σ·eps``), the
uncond side on the network input scaled by ``cfg.uncond_input_scale``, and
basic CFG ``uncond + (cond − uncond)·scale``. The network runs in
``dtype``; everything else in float32."""

from __future__ import annotations

import math

import torch


def guided(cond_denoised: torch.Tensor, uncond_denoised: torch.Tensor, scale: float):
    return uncond_denoised + (cond_denoised - uncond_denoised) * scale


def denoiser(network, params: dict, config: dict, traffic: dict, dtype=torch.float32):
    cfg = traffic["cfg"]
    s_unc, scale = float(cfg["uncond_input_scale"]), float(cfg["scale"])
    p = {k: v.to(dtype) for k, v in params.items()}

    def denoise(x, sigma):
        sb = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        xin = x / math.sqrt(sigma * sigma + 1.0)
        cond = x - sigma * network(p, config, xin, sb, dtype)
        uncond = x - sigma * network(p, config, xin * s_unc, sb, dtype)
        return guided(cond, uncond, scale)

    return denoise
