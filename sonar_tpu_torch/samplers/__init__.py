"""Sonar momentum samplers. This slice ports ``sonar_euler`` and
``sonar_euler_ancestral``; ``sonar_dpmpp_sde`` and the k-diffusion registry
come in later slices."""

from .ancestral import get_ancestral_step, get_ancestral_step_rf, to_d  # noqa: F401
from .momentum import (  # noqa: F401
    GuidanceConfig,
    GuidanceType,
    HistoryType,
    MomentumMode,
    SonarConfig,
)
from .sonar import sample_sonar_euler, sample_sonar_euler_ancestral  # noqa: F401
