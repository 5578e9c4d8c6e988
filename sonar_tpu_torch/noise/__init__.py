from .base import (NoiseCtx, NoiseItem, NoiseSamplerHandle, fix_output_frames,
                   make_noise_sampler)
from .brownian import brownian_increment, brownian_w, brownian_w_at
from .combinators import ScheduledNoise, WrapperNoise
from .generators import (
    BrownianGenerator,
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
from .power import (PowerFilter, PowerFilterNoiseItem, PowerNoiseItem,
                    apply_channel_mixer, build_channel_mixer, rfft2_to_fft2)
from .presets import NOISE_TYPES, get_noise_item
from .voronoi import VoronoiGenerator

__all__ = [
    "BrownianGenerator",
    "GaussianGenerator",
    "Generator",
    "HighresPyramidGenerator",
    "MixedGenerator",
    "NOISE_TYPES",
    "NoiseCtx",
    "NoiseChain",
    "NoiseItem",
    "NoiseSamplerHandle",
    "PowerFilter",
    "PowerFilterNoiseItem",
    "PowerNoiseItem",
    "PyramidGenerator",
    "PyramidOldGenerator",
    "ScheduledNoise",
    "TypedNoiseItem",
    "UniformGenerator",
    "VoronoiGenerator",
    "WrapperNoise",
    "apply_channel_mixer",
    "brownian_increment",
    "brownian_w",
    "brownian_w_at",
    "build_channel_mixer",
    "fix_output_frames",
    "get_noise_item",
    "make_noise_sampler",
    "rfft2_to_fft2",
]
