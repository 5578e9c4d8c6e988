"""The ``dit`` family in the program: ``sonar_tpu_torch.models.DiT`` (dense
MLP) on the benchmark's weights, through the port's ``make_dit_denoiser``."""

from __future__ import annotations

import math

import torch

from ._common import guided_models, load_weights
from .unet import DTYPES


def port_config(cfg: dict):
    from sonar_tpu_torch.models import DiTConfig

    return DiTConfig(in_channels=cfg["in_channels"], patch_size=cfg["patch_size"],
                     hidden=cfg["hidden"], depth=cfg["depth"], num_heads=cfg["num_heads"],
                     mlp_ratio=cfg["mlp_ratio"], dtype=DTYPES[cfg["dtype"]])


def build(cfg: dict, params: dict, traffic: dict, device) -> dict:
    from sonar_tpu_torch.models import DiT, make_dit_denoiser

    with torch.device("meta"):
        module = DiT(port_config(cfg))
    return guided_models(make_dit_denoiser, load_weights(module, params), traffic, device)


def forward_flops(cfg: dict, shape) -> float:
    """The port's own count (``models/flops.py``), which the tests hold the
    frozen one (``benchmark/flops/dit.py``) to."""
    from sonar_tpu_torch.models import flops

    return flops.dit_forward_flops(port_config(cfg), shape)


def _attention_over_queries(self, x):
    b, n, d = x.shape
    dh = d // self.cfg.num_heads
    qkv = self.qkv(x).reshape(b, n, self.cfg.num_heads, 3, dh)
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    att = torch.softmax(logits / math.sqrt(dh), dim=-2)
    return self.attn_out(torch.matmul(att.to(x.dtype), v).transpose(1, 2).reshape(b, n, d))


def attention_axis() -> list:
    """The ``attention_axis`` fault's patches (``faults.py``): every block's
    attention (``models/dit.py Block.attention``) takes its softmax over the
    queries instead of the keys."""
    from sonar_tpu_torch.models.dit import Block

    return [(Block, "attention", _attention_over_queries)]
