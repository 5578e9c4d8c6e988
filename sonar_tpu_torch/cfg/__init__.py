"""Model-patch subsystems that consume the denoiser (port of
``sonar_tpu.cfg``): wavelet CFG, FreeU-Extreme, latent operations and the
model-sampling protocol."""

from .freeu import FreeUExtremeConfig, ffilter, make_freeu_patches
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
    "FreeUExtremeConfig",
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
    "ffilter",
    "make_beta_sigmas",
    "make_freeu_patches",
    "max_denoise",
    "schedule_interp",
    "time_snr_shift",
]
