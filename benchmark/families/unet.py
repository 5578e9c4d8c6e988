"""The ``unet`` family in the program: ``sonar_tpu_torch.models.UNet`` on
the benchmark's weights, through the port's ``make_denoiser``."""

from __future__ import annotations

import torch

from ._common import guided_models, load_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def build(cfg: dict, params: dict, traffic: dict, device) -> dict:
    from sonar_tpu_torch.models import UNet, UNetConfig, make_denoiser

    ucfg = UNetConfig(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                      model_channels=cfg["model_channels"],
                      channel_mult=tuple(cfg["channel_mult"]),
                      num_res_blocks=cfg["num_res_blocks"],
                      attention_levels=tuple(cfg["attention_levels"]),
                      num_heads=cfg["num_heads"], norm_groups=cfg["norm_groups"],
                      dtype=DTYPES[cfg["dtype"]])
    with torch.device("meta"):
        module = UNet(ucfg)
    return guided_models(make_denoiser, load_weights(module, params), traffic, device)
