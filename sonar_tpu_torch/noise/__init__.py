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
from .chain import NoiseChain
from .items import TypedNoiseItem
from .presets import NOISE_TYPES, get_noise_item
from .voronoi import VoronoiGenerator

__all__ = [
    "GaussianGenerator",
    "Generator",
    "HighresPyramidGenerator",
    "MixedGenerator",
    "NOISE_TYPES",
    "NoiseCtx",
    "NoiseChain",
    "NoiseItem",
    "NoiseSamplerHandle",
    "PyramidGenerator",
    "PyramidOldGenerator",
    "TypedNoiseItem",
    "UniformGenerator",
    "VoronoiGenerator",
    "fix_output_frames",
    "get_noise_item",
    "make_noise_sampler",
]
