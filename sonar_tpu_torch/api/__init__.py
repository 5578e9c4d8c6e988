"""High-level user API (port of ``sonar_tpu.api``): the functional node
equivalents, the sampler registry, the CFG-time latent-op guider and
``SonarPipeline``. The node builders, workflow porting, YAML config
loaders, preview tooling and extensions (``nodes``, ``workflow``,
``config``, ``preview``, ``extensions``) are not ported yet."""

from .functions import (SAMPLERS, get_sampler, noise_image, noisy_latent_like,
                        register_sampler, sampler_config_override, split_noise_chain)
from .guider import make_latent_op_cfg_function
from .pipeline import SonarPipeline

__all__ = [
    "SAMPLERS",
    "SonarPipeline",
    "get_sampler",
    "make_latent_op_cfg_function",
    "noise_image",
    "noisy_latent_like",
    "register_sampler",
    "sampler_config_override",
    "split_noise_chain",
]
