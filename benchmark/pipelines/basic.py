"""The ``basic`` pipeline: ``SonarPipeline`` with the traffic's sampler
(any registry name), ``SonarConfig`` fields, noise type (any registry name,
with ``noise_params``) and basic CFG at ``cfg.scale``."""

from __future__ import annotations


def build(models: dict, traffic: dict):
    from sonar_tpu_torch.api.pipeline import SonarPipeline
    from sonar_tpu_torch.noise.presets import get_noise_item
    from sonar_tpu_torch.samplers.momentum import SonarConfig

    return SonarPipeline(**models, sampler=traffic["sampler"],
                         sonar_config=SonarConfig(**traffic.get("sonar_config", {})),
                         noise=get_noise_item(traffic["noise"], **traffic.get("noise_params", {})),
                         cfg_scale=float(traffic["cfg"]["scale"]))
