"""The ``basic`` pipeline: ``SonarPipeline`` with the traffic's sampler
(any registry name), ``SonarConfig`` fields, noise type (any registry name,
with ``noise_params``), basic CFG at ``cfg.scale`` (none under ``cfg.mode``
"none": the one model is called unguided) and, under a flow
``model_sampling``, the port's ``Flow`` (``families/_common.py flow``), which
gives ancestral samplers the rectified-flow split."""

from __future__ import annotations

from ..families._common import flow


def build(models: dict, traffic: dict):
    from sonar_tpu_torch.api.pipeline import SonarPipeline
    from sonar_tpu_torch.noise.presets import get_noise_item
    from sonar_tpu_torch.samplers.momentum import SonarConfig

    kw = {}
    if traffic["cfg"]["mode"] != "none":
        kw["cfg_scale"] = float(traffic["cfg"]["scale"])
    ms = flow(traffic)
    if ms is not None:
        kw["model_sampling"] = ms
    return SonarPipeline(**models, sampler=traffic["sampler"],
                         sonar_config=SonarConfig(**traffic.get("sonar_config", {})),
                         noise=get_noise_item(traffic["noise"], **traffic.get("noise_params", {})),
                         **kw)
