"""The noise-type registry (port of ``sonar_tpu.noise.presets``; reference
py/noise.py:2244-2489).

The JAX registry imports the whole zoo when it is imported. The port
registers lazily instead: a name maps to a loader that imports its generator
module only when that name is first asked for, so the main path loads only
the gaussian generator. This slice registers ``gaussian`` and ``uniform``;
later slices add the rest of the zoo to ``_LOADERS``.
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


_LOADERS: dict[str, Callable[[], Callable[..., Generator]]] = {
    "gaussian": _load_gaussian,
    "uniform": _load_uniform,
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
