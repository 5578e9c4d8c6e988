from .blend import BLENDING_MODES, blend
from .normalize import normalize_to_scale, scale_noise, tmedian, tstd
from .rng import derive_seed, seed_from

__all__ = [
    "BLENDING_MODES",
    "blend",
    "derive_seed",
    "normalize_to_scale",
    "scale_noise",
    "seed_from",
    "tmedian",
    "tstd",
]
