from .blend import BLENDING_MODES, blend
from .normalize import scale_noise, tstd
from .rng import derive_seed, make_generator, seed_from

__all__ = [
    "BLENDING_MODES",
    "blend",
    "derive_seed",
    "make_generator",
    "scale_noise",
    "seed_from",
    "tstd",
]
