"""The ``unet`` family in the program: ``sonar_tpu_torch.models.UNet`` on
the benchmark's weights, through the port's ``make_denoiser``."""

from __future__ import annotations

import math

import torch

from ._common import guided_models, load_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def port_config(cfg: dict):
    from sonar_tpu_torch.models import UNetConfig

    return UNetConfig(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                      model_channels=cfg["model_channels"],
                      channel_mult=tuple(cfg["channel_mult"]),
                      num_res_blocks=cfg["num_res_blocks"],
                      attention_levels=tuple(cfg["attention_levels"]),
                      num_heads=cfg["num_heads"], norm_groups=cfg["norm_groups"],
                      dtype=DTYPES[cfg["dtype"]])


def build(cfg: dict, params: dict, traffic: dict, device) -> dict:
    from sonar_tpu_torch.models import UNet, make_denoiser

    with torch.device("meta"):
        module = UNet(port_config(cfg))
    return guided_models(make_denoiser, load_weights(module, params), traffic, device)


def forward_flops(cfg: dict, shape) -> float:
    """The port's own count (``models/flops.py``), which the tests hold the
    frozen one (``benchmark/flops/unet.py``) to."""
    from sonar_tpu_torch.models import flops

    return flops.unet_forward_flops(port_config(cfg), shape)


def _attention_over_queries(self, x):
    b, c, h, w = x.shape
    n, heads = h * w, self.num_heads
    y = self.norm(x).reshape(b, c, n).transpose(1, 2)
    q, k, v = self.qkv(y).reshape(b, n, 3, heads, c // heads).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / math.sqrt(c // heads)
    attn = torch.softmax(logits, dim=-2).to(x.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
    return x + self.proj(out).transpose(1, 2).reshape(b, c, h, w)


def attention_axis() -> list:
    """The ``attention_axis`` fault's patches (``faults.py``): every
    attention block (``models/unet.py Attention.forward``) takes its softmax
    over the queries instead of the keys."""
    from sonar_tpu_torch.models.unet import Attention

    return [(Attention, "forward", _attention_over_queries)]
