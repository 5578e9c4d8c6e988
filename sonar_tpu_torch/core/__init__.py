from .blend import BLENDING_MODES, blend
from .normalize import scale_noise, tstd
from .rng import derive_seed, seed_from

__all__ = [
    "BLENDING_MODES",
    "blend",
    "derive_seed",
    "scale_noise",
    "seed_from",
    "tstd",
]
