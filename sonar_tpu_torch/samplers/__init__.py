"""Sonar momentum samplers: ``sonar_euler``, ``sonar_euler_ancestral`` and
``sonar_dpmpp_sde``, and the sigma schedules; the k-diffusion registry comes
in a later slice."""

from .ancestral import get_ancestral_step, get_ancestral_step_rf, to_d  # noqa: F401
from .momentum import (  # noqa: F401
    GuidanceConfig,
    GuidanceType,
    HistoryType,
    MomentumMode,
    SonarConfig,
)
from .schedules import SCHEDULERS, get_sigmas  # noqa: F401
from .sonar import (  # noqa: F401
    sample_sonar_dpmpp_sde,
    sample_sonar_euler,
    sample_sonar_euler_ancestral,
)
