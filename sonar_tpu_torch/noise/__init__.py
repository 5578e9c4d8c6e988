from .base import (NoiseCtx, NoiseItem, NoiseSamplerHandle, fix_output_frames,
                   make_noise_sampler)
from .generators import (
    GaussianGenerator,
    Generator,
    HighresPyramidGenerator,
    MixedGenerator,
    PyramidGenerator,
    PyramidOldGenerator,
    UniformGenerator,
)
from .presets import NOISE_TYPES, get_noise_item

__all__ = [
    "GaussianGenerator",
    "Generator",
    "HighresPyramidGenerator",
    "MixedGenerator",
    "NOISE_TYPES",
    "NoiseCtx",
    "NoiseItem",
    "NoiseSamplerHandle",
    "PyramidGenerator",
    "PyramidOldGenerator",
    "UniformGenerator",
    "fix_output_frames",
    "get_noise_item",
    "make_noise_sampler",
]
