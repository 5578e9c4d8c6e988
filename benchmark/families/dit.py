"""The ``dit`` family in the program: ``sonar_tpu_torch.models.DiT`` (dense
MLP) on the benchmark's weights, through the port's ``make_dit_denoiser``."""

from __future__ import annotations

import torch

from ._common import guided_models, load_weights
from .unet import DTYPES


def build(cfg: dict, params: dict, traffic: dict, device) -> dict:
    from sonar_tpu_torch.models import DiT, DiTConfig, make_dit_denoiser

    dcfg = DiTConfig(in_channels=cfg["in_channels"], patch_size=cfg["patch_size"],
                     hidden=cfg["hidden"], depth=cfg["depth"], num_heads=cfg["num_heads"],
                     mlp_ratio=cfg["mlp_ratio"], dtype=DTYPES[cfg["dtype"]])
    with torch.device("meta"):
        module = DiT(dcfg)
    return guided_models(make_dit_denoiser, load_weights(module, params), traffic, device)
