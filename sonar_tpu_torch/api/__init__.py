"""High-level user API (port of ``sonar_tpu.api``): the functional node
equivalents, the sampler registry, the node-name builder registry and its
schema validation, ComfyUI workflow porting into ``SonarPipeline``, the
YAML config loaders (PyYAML is imported only to parse a YAML text), preview
tooling, the CFG-time latent-op guider and extensions."""

from . import extensions
from .config import (load_yaml_params, sonar_config_from_yaml, wavelet_cfg_from_yaml,
                     wcfg_rules_from_yaml)
from .functions import (SAMPLERS, get_sampler, noise_image, noisy_latent_like,
                        register_sampler, sampler_config_override, split_noise_chain)
from .guider import make_latent_op_cfg_function
from .nodes import NODES, build, register_node, tristate
from .pipeline import SonarPipeline
from .preview import noise_to_rgb, preview_power_filter, preview_power_noise
from .workflow import PortResult, pipeline_from_workflow, port_workflow, read_workflow

__all__ = [
    "NODES",
    "PortResult",
    "SAMPLERS",
    "SonarPipeline",
    "build",
    "extensions",
    "get_sampler",
    "load_yaml_params",
    "make_latent_op_cfg_function",
    "noise_image",
    "noise_to_rgb",
    "noisy_latent_like",
    "pipeline_from_workflow",
    "port_workflow",
    "preview_power_filter",
    "preview_power_noise",
    "read_workflow",
    "register_node",
    "register_sampler",
    "sampler_config_override",
    "sonar_config_from_yaml",
    "split_noise_chain",
    "tristate",
    "wavelet_cfg_from_yaml",
    "wcfg_rules_from_yaml",
]
