"""The ``basic`` pipeline's guided denoiser: the traffic's prediction
around the network (``reference/prediction.py``: eps, or CONST under a flow
``model_sampling``, the network then conditioned on ``σ·multiplier``;
``denoised = x − σ·out``), the
uncond side on the network input scaled by ``cfg.uncond_input_scale``, and
basic CFG ``uncond + (cond − uncond)·scale``; under ``cfg.mode`` "none" the
cond side alone. The network runs in ``dtype``; everything else in
float32."""

from __future__ import annotations

import torch

from ... import traffic as traffic_mod
from .. import prediction


def guided(cond_denoised: torch.Tensor, uncond_denoised: torch.Tensor, scale: float):
    return uncond_denoised + (cond_denoised - uncond_denoised) * scale


def denoiser(network, params: dict, config: dict, traffic: dict, dtype=torch.float32):
    cfg = traffic["cfg"]
    pred = traffic_mod.prediction(traffic)
    ms = traffic_mod.model_sampling(traffic)
    p = {k: v.to(dtype) for k, v in params.items()}

    def side(x, xin, sigma, sb):
        c = sb if ms is None else sb * float(ms["multiplier"])
        return x - sigma * network(p, config, xin, c, dtype)

    def denoise(x, sigma):
        sb = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        xin = prediction.network_input(pred, x, sigma)
        cond = side(x, xin, sigma, sb)
        if cfg["mode"] == "none":
            return cond
        uncond = side(x, xin * float(cfg["uncond_input_scale"]), sigma, sb)
        return guided(cond, uncond, float(cfg["scale"]))

    return denoise
