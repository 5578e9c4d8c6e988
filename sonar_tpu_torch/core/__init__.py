from .blend import BLENDING_MODES, blend, blend_scalar, register_blend_mode
from .normalize import (normalize_to_scale, normalize_to_scale_adv, quantile_normalize, scale_noise, tmedian, tmode,
                        tquantile, tstd)
from .rng import derive_seed, seed_from

__all__ = [
    "BLENDING_MODES",
    "blend",
    "blend_scalar",
    "derive_seed",
    "normalize_to_scale",
    "normalize_to_scale_adv",
    "quantile_normalize",
    "register_blend_mode",
    "scale_noise",
    "seed_from",
    "tmedian",
    "tmode",
    "tquantile",
    "tstd",
]
