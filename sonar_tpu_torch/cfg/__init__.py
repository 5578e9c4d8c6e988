"""Model-patch subsystems that consume the denoiser (port of
``sonar_tpu.cfg``): wavelet CFG, latent operations and the model-sampling
protocol. FreeU-Extreme (``freeu.py``) is not ported yet."""

from .latent_ops import (
    SonarLatentOperation,
    SonarLatentOperationAdvanced,
    SonarLatentOperationNoise,
    SonarLatentOperationQuantileFilter,
    apply_operations,
)
from .model_sampling import (
    ContinuousEDM,
    DiscreteSampling,
    Flow,
    make_beta_sigmas,
    max_denoise,
    time_snr_shift,
)
from .wavelet_cfg import (
    WaveletCFG,
    WCFGPercentages,
    WCFGRule,
    WCFGRules,
    WCFGScales,
    WCFGScalesRange,
    WCFGScheduledFloat,
    WCFGScheduledScale,
    WCFGWaveletSettings,
    apply_wcfg_scales,
    basic_cfg,
    schedule_interp,
)

__all__ = [
    "ContinuousEDM",
    "DiscreteSampling",
    "Flow",
    "SonarLatentOperation",
    "SonarLatentOperationAdvanced",
    "SonarLatentOperationNoise",
    "SonarLatentOperationQuantileFilter",
    "WCFGPercentages",
    "WCFGRule",
    "WCFGRules",
    "WCFGScales",
    "WCFGScalesRange",
    "WCFGScheduledFloat",
    "WCFGScheduledScale",
    "WCFGWaveletSettings",
    "WaveletCFG",
    "apply_operations",
    "apply_wcfg_scales",
    "basic_cfg",
    "make_beta_sigmas",
    "max_denoise",
    "schedule_interp",
    "time_snr_shift",
]
