from .base import NoiseCtx, NoiseItem, NoiseSamplerHandle, make_noise_sampler
from .generators import GaussianGenerator, Generator, UniformGenerator
from .presets import NOISE_TYPES, get_noise_item

__all__ = [
    "GaussianGenerator",
    "Generator",
    "NOISE_TYPES",
    "NoiseCtx",
    "NoiseItem",
    "NoiseSamplerHandle",
    "UniformGenerator",
    "get_noise_item",
    "make_noise_sampler",
]
