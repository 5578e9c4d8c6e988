"""The noise-type registry (port of ``sonar_tpu.noise.presets``; reference
py/noise.py:2244-2489).

The JAX registry imports the whole zoo when it is imported. The port
registers lazily instead: a name maps to a loader that imports its generator
module only when that name is first asked for, so the main path loads only
the gaussian generator. Registered: all 38 of the JAX registry's names,
with its exact parameters (presets.py:64-221, 177-221).
"""

from __future__ import annotations

import importlib
from typing import Callable

from .generators import Generator

NOISE_TYPES: dict[str, Callable[..., Generator]] = {}


def _simple(cls, **preset):
    def factory(factor=1.0, normalize=None, **kwargs):
        return cls(factor, normalize=normalize, **(preset | kwargs))

    return factory


def _mixed(mix_name, members, output_fun=None):
    """members: tuple of (cls, preset_kwargs, transform)."""
    from .generators import MixedGenerator

    def factory(factor=1.0, normalize=None, **kwargs):
        mix = tuple((cls(**mkw), transform) for cls, mkw, transform in members)
        return MixedGenerator(factor, normalize=normalize, mix_name=mix_name,
                              noise_mix=mix, output_fun=output_fun, **kwargs)

    return factory


def _load(cls_name: str, **preset):
    """A loader of one generator class of :mod:`.generators` with a preset."""

    def load():
        from . import generators

        return _simple(getattr(generators, cls_name), **preset)

    return load


def _load_mix(name: str, members, output_fun=None):
    """A loader of a mix of :mod:`.generators` classes: members are
    (class name, preset, transform)."""

    def load():
        from . import generators

        return _mixed(name, tuple((getattr(generators, c), kw, t) for c, kw, t in members),
                      output_fun=output_fun)

    return load


def _load_pyramid_mix(name: str, **member):
    """A pyramid mix: two PyramidGenerators with transforms 0.2 and -0.8."""
    return _load_mix(name, (("PyramidGenerator", member, 0.2),
                            ("PyramidGenerator", member, -0.8)))


def _load_late(module: str, cls_name: str):
    """A loader of a generator class that lives in a module of its own."""

    def load():
        return _simple(getattr(importlib.import_module(f".{module}", __package__), cls_name))

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
    "gaussian": _load("GaussianGenerator"),
    "uniform": _load("UniformGenerator"),
    "brownian": _load("BrownianGenerator"),
    "perlin": _load("PerlinOldGenerator"),
    "studentt": _load("StudentTGenerator"),
    "pink_old": _load("PinkOldGenerator"),
    "power_old": _load("PowerOldGenerator"),
    "laplacian": _load("LaplacianGenerator"),
    "green_test": _load("GreenTestGenerator"),
    "pyramid_old": _load("PyramidOldGenerator"),
    "pyramid": _load("PyramidGenerator"),
    "highres_pyramid": _load("HighresPyramidGenerator"),
    "onef_pinkish": _load("OneFGenerator", alpha=-0.5),
    "onef_greenish": _load("OneFGenerator", alpha=0.5),
    "onef_pinkishgreenish": _load_mix(
        "onef_pinkishgreenish", (("OneFGenerator", {"alpha": 0.5}, None),
                                 ("OneFGenerator", {"alpha": -0.5}, None)), output_fun=0.5),
    "onef_pinkish_mix": _load_mix(
        "onef_pinkish_mix", (("OneFGenerator", {"alpha": -0.5}, -1.0),
                             ("OneFGenerator", {"alpha": -0.5}, None)), output_fun=0.5),
    "onef_greenish_mix": _load_mix(
        "onef_greenish_mix", (("OneFGenerator", {"alpha": 0.5}, -1.0),
                              ("OneFGenerator", {"alpha": 0.5}, None)), output_fun=0.5),
    "white": _load("PowerLawGenerator", alpha=0.0, use_sign=True),
    "grey": _load("PowerLawGenerator", alpha=0.0, use_sign=False),
    "velvet": _load("PowerLawGenerator", alpha=1.0, use_sign=True, div_max_dims=(-3, -2, -1)),
    "violet": _load("PowerLawGenerator", alpha=0.5, use_sign=True, div_max_dims=(-3, -2, -1)),
    "rainbow_mild": _load_mix(
        "rainbow_mild", (("GreenTestGenerator", {}, 0.55), ("GreenTestGenerator", {}, 0.7)),
        output_fun=1.15),
    "rainbow_intense": _load_mix(
        "rainbow_intense", (("GreenTestGenerator", {}, 0.75), ("GreenTestGenerator", {}, 0.5)),
        output_fun=1.15),
    "pyramid_bislerp": _load("PyramidGenerator", upscale_mode="bislerp"),
    "highres_pyramid_bislerp": _load("HighresPyramidGenerator", upscale_mode="bislerp"),
    "pyramid_area": _load("PyramidGenerator", upscale_mode="area"),
    "highres_pyramid_area": _load("HighresPyramidGenerator", upscale_mode="area"),
    "pyramid_old_bislerp": _load("PyramidOldGenerator", upscale_mode="bislerp"),
    "pyramid_old_area": _load("PyramidOldGenerator", upscale_mode="area"),
    "pyramid_discount5": _load("PyramidGenerator", discount=0.5),
    "pyramid_mix": _load_pyramid_mix("pyramid_mix", discount=0.6),
    "pyramid_mix_area": _load_pyramid_mix("pyramid_mix_area", discount=0.5,
                                          upscale_mode="area"),
    "pyramid_mix_bislerp": _load_pyramid_mix("pyramid_mix_bislerp", discount=0.5,
                                             upscale_mode="bislerp"),
    "voronoi_fuzz": _load_voronoi_fuzz,
    "voronoi_mix": _load_voronoi_mix,
    "distro": _load_late("distro", "DistroGenerator"),
    "collatz": _load_late("collatz", "CollatzGenerator"),
    "wavelet": _load_late("wavelet", "WaveletGenerator"),
}


def register_noise_type(name: str, factory: Callable[..., Generator]) -> None:
    """Register (or replace) the factory of a noise type name."""
    NOISE_TYPES[name] = factory


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


def noise_type_names(default: str | None = "gaussian", skip=None):
    """Default-first name iteration (py/noise_generation.py:71-80): the
    registered names and those still to load, sorted."""
    names = sorted(set(NOISE_TYPES) | set(_LOADERS))
    if default is not None:
        yield default
    for n in names:
        if n == default or (skip and n in skip):
            continue
        yield n
