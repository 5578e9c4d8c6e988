"""The noise-type registry (port of ``sonar_tpu.noise.presets``; reference
py/noise.py:2244-2489).

The JAX registry imports the whole zoo when it is imported. The port
registers lazily instead: a name maps to a loader that imports its generator
module only when that name is first asked for, so the main path loads only
the gaussian generator. Registered so far: ``gaussian``, ``uniform``,
``brownian``, the thirteen pyramid-family names and the two Voronoi presets,
with the JAX registry's exact parameters (presets.py:66, 73-75, 128-174,
188-221); later slices add the rest of the zoo to ``_LOADERS``.
"""

from __future__ import annotations

from typing import Callable

from .generators import Generator

NOISE_TYPES: dict[str, Callable[..., Generator]] = {}


def _simple(cls, **preset):
    def factory(factor=1.0, normalize=None, **kwargs):
        return cls(factor, normalize=normalize, **(preset | kwargs))

    return factory


def _load_gaussian():
    from .generators import GaussianGenerator

    return _simple(GaussianGenerator)


def _load_uniform():
    from .generators import UniformGenerator

    return _simple(UniformGenerator)


def _load_brownian():
    from .generators import BrownianGenerator

    return _simple(BrownianGenerator)


def _mixed(mix_name, members, output_fun=None):
    """members: tuple of (cls, preset_kwargs, transform)."""
    from .generators import MixedGenerator

    def factory(factor=1.0, normalize=None, **kwargs):
        mix = tuple((cls(**mkw), transform) for cls, mkw, transform in members)
        return MixedGenerator(factor, normalize=normalize, mix_name=mix_name,
                              noise_mix=mix, output_fun=output_fun, **kwargs)

    return factory


def _load_pyramid(cls_name: str, **preset):
    def load():
        from . import generators

        return _simple(getattr(generators, cls_name), **preset)

    return load


def _load_pyramid_mix(name: str, **member):
    """A pyramid mix: two PyramidGenerators with transforms 0.2 and -0.8."""

    def load():
        from .generators import PyramidGenerator

        return _mixed(name, ((PyramidGenerator, member, 0.2),
                             (PyramidGenerator, member, -0.8)))

    return load


def _load_voronoi_fuzz():
    from .voronoi import VoronoiGenerator

    return _simple(VoronoiGenerator, n_points=(256,), octaves=1,
                   distance_mode=("fuzz:name=angle_tanh:fuzz=0.1",),
                   result_mode=("diff2",), z_max=0.0)


def _load_voronoi_mix():
    from .generators import GaussianGenerator
    from .voronoi import VoronoiGenerator

    voronoi = {"n_points": (256,), "octaves": 3, "distance_mode": ("euclidean",),
               "result_mode": ("diff2",), "octave_mode": "new_features",
               "lacunarity": 2.0, "gain": 0.75, "z_max": 0.0}
    return _mixed("voronoi_mix", ((VoronoiGenerator, voronoi, 0.6),
                                  (GaussianGenerator, {}, 0.4)))


_LOADERS: dict[str, Callable[[], Callable[..., Generator]]] = {
    "gaussian": _load_gaussian,
    "uniform": _load_uniform,
    "brownian": _load_brownian,
    "pyramid_old": _load_pyramid("PyramidOldGenerator"),
    "pyramid": _load_pyramid("PyramidGenerator"),
    "highres_pyramid": _load_pyramid("HighresPyramidGenerator"),
    "pyramid_bislerp": _load_pyramid("PyramidGenerator", upscale_mode="bislerp"),
    "highres_pyramid_bislerp": _load_pyramid("HighresPyramidGenerator",
                                             upscale_mode="bislerp"),
    "pyramid_area": _load_pyramid("PyramidGenerator", upscale_mode="area"),
    "highres_pyramid_area": _load_pyramid("HighresPyramidGenerator",
                                          upscale_mode="area"),
    "pyramid_old_bislerp": _load_pyramid("PyramidOldGenerator", upscale_mode="bislerp"),
    "pyramid_old_area": _load_pyramid("PyramidOldGenerator", upscale_mode="area"),
    "pyramid_discount5": _load_pyramid("PyramidGenerator", discount=0.5),
    "pyramid_mix": _load_pyramid_mix("pyramid_mix", discount=0.6),
    "pyramid_mix_area": _load_pyramid_mix("pyramid_mix_area", discount=0.5,
                                          upscale_mode="area"),
    "pyramid_mix_bislerp": _load_pyramid_mix("pyramid_mix_bislerp", discount=0.5,
                                             upscale_mode="bislerp"),
    "voronoi_fuzz": _load_voronoi_fuzz,
    "voronoi_mix": _load_voronoi_mix,
}


def _factory(name: str):
    if name not in NOISE_TYPES and name in _LOADERS:
        NOISE_TYPES[name] = _LOADERS[name]()
    return NOISE_TYPES.get(name)


def get_noise_item(
    noise_type: str | None, factor: float = 1.0, normalize: bool | None = None, **kwargs
) -> Generator:
    """String dispatch (py/noise.py:2460-2489)."""
    name = "gaussian" if noise_type is None else noise_type.lower()
    factory = _factory(name)
    if factory is None:
        valid = ", ".join(sorted(set(NOISE_TYPES) | set(_LOADERS)))
        raise ValueError(f"Unknown noise type {noise_type!r}; valid: {valid}")
    return factory(factor=factor, normalize=normalize, **kwargs)
