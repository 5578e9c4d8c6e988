"""The sampler registry (port of ``sonar_tpu.samplers``): the three sonar
momentum samplers, restart sampling and the k-diffusion set (31 names in
``SAMPLERS``), and the sigma schedules."""

from .ancestral import get_ancestral_step, get_ancestral_step_rf, to_d  # noqa: F401
from .dpm_solver import sample_dpm_adaptive, sample_dpm_fast
from .kdiffusion import (
    KDIFFUSION_SAMPLERS,
    sample_ddim,
    sample_ddpm,
    sample_dpm_2,
    sample_dpm_2_ancestral,
    sample_dpmpp_2m,
    sample_dpmpp_2m_sde,
    sample_dpmpp_2s_ancestral,
    sample_dpmpp_3m_sde,
    sample_dpmpp_sde,
    sample_euler,
    sample_euler_ancestral,
    sample_heun,
    sample_heunpp2,
    sample_lcm,
    sample_res_multistep,
    sample_res_multistep_ancestral,
)
from .momentum import (  # noqa: F401
    GuidanceConfig,
    GuidanceType,
    HistoryType,
    MomentumMode,
    SonarConfig,
)
from .multistep import (
    sample_deis,
    sample_ipndm,
    sample_ipndm_v,
    sample_lms,
    sample_uni_pc,
    sample_uni_pc_bh2,
)
from .restart import RestartSegment, default_segments, sample_restart
from .schedules import SCHEDULERS, get_sigmas  # noqa: F401
from .sonar import (
    sample_sonar_dpmpp_sde,
    sample_sonar_euler,
    sample_sonar_euler_ancestral,
)

SAMPLERS = {
    "sonar_euler": sample_sonar_euler,
    "sonar_euler_ancestral": sample_sonar_euler_ancestral,
    "sonar_dpmpp_sde": sample_sonar_dpmpp_sde,
    "restart": sample_restart,
    **KDIFFUSION_SAMPLERS,
}

__all__ = [
    "KDIFFUSION_SAMPLERS",
    "SAMPLERS",
    "GuidanceConfig",
    "HistoryType",
    "MomentumMode",
    "SonarConfig",
    "RestartSegment",
    "default_segments",
    "get_ancestral_step",
    "sample_ddim",
    "sample_ddpm",
    "sample_deis",
    "sample_dpm_2",
    "sample_dpm_2_ancestral",
    "sample_dpm_adaptive",
    "sample_dpm_fast",
    "sample_dpmpp_2m",
    "sample_dpmpp_2m_sde",
    "sample_dpmpp_2s_ancestral",
    "sample_dpmpp_3m_sde",
    "sample_dpmpp_sde",
    "sample_euler",
    "sample_euler_ancestral",
    "sample_heun",
    "sample_heunpp2",
    "sample_ipndm",
    "sample_ipndm_v",
    "sample_lcm",
    "sample_lms",
    "sample_res_multistep",
    "sample_res_multistep_ancestral",
    "sample_restart",
    "sample_uni_pc",
    "sample_uni_pc_bh2",
    "sample_sonar_dpmpp_sde",
    "sample_sonar_euler",
    "sample_sonar_euler_ancestral",
    "to_d",
]
