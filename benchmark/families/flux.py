"""The ``flux`` family in the program: ``sonar_tpu_torch.models.Flux`` on
the benchmark's weights, through the port's ``make_flux_denoiser`` with the
prompt's encodings (``cond.txt``, ``cond.y``, drawn with the weights) and
the configuration's guidance value bound."""

from __future__ import annotations

import functools
import math

import torch

from ._common import guided_models, load_weights
from .unet import DTYPES


def port_config(cfg: dict):
    from sonar_tpu_torch.models import FluxConfig

    return FluxConfig(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                      vec_in_dim=cfg["vec_in_dim"], context_in_dim=cfg["context_in_dim"],
                      hidden_size=cfg["hidden_size"], mlp_ratio=cfg["mlp_ratio"],
                      num_heads=cfg["num_heads"], depth=cfg["depth"],
                      depth_single_blocks=cfg["depth_single_blocks"],
                      axes_dim=tuple(cfg["axes_dim"]), theta=cfg["theta"],
                      dtype=DTYPES[cfg["dtype"]])


def build(cfg: dict, params: dict, traffic: dict, device) -> dict:
    from sonar_tpu_torch.models import Flux, make_flux_denoiser

    params = dict(params)
    context, y = params.pop("cond.txt"), params.pop("cond.y")
    with torch.device("meta"):
        module = Flux(port_config(cfg))
    make = functools.partial(make_flux_denoiser, context=context, y=y,
                             guidance=float(cfg["guidance"]))
    return guided_models(make, load_weights(module, params), traffic, device)


def forward_flops(cfg: dict, shape) -> float:
    """The port's own count (``models/flops.py``), which the tests hold the
    frozen one (``benchmark/flops/flux.py``) to."""
    from sonar_tpu_torch.models import flops

    return flops.flux_forward_flops(port_config(cfg), shape, cfg["context_tokens"])


def attention_launch_flops(cfg: dict, shape) -> float:
    """The operations of one B7 launch (``metrics/attention_roofline_pct``):
    every block's launch runs over the joint sequence, the latent's 2×2
    patches plus ``context_tokens`` text tokens, ``4·b·heads·n²·d`` (the
    score and value products). ``d`` is the published head width, so work on
    zero-filled dimensions counts as waste."""
    b, _, h, w = shape
    n = (h // 2) * (w // 2) + cfg["context_tokens"]
    d = cfg["hidden_size"] // cfg["num_heads"]
    return 4.0 * b * cfg["num_heads"] * n * n * d


def _softmax_over_queries(qkv, layout):
    b, n, _, heads, d = qkv.shape
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / math.sqrt(d)
    attn = torch.softmax(logits, dim=-2).to(qkv.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, heads * d)


def attention_axis() -> list:
    """The ``attention_axis`` fault's patches (``faults.py``): every block's
    attention core (``models/flux.py``'s call of ``fused_attention``, in both
    block kinds) takes its softmax over the queries instead of the keys."""
    from sonar_tpu_torch.models import flux

    return [(flux, "fused_attention", _softmax_over_queries)]
