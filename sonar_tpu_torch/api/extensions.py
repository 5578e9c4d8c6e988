"""Native extension registry + discovery (port of
``sonar_tpu.api.extensions``) — the framework-side counterpart of the
reference's lazy integration layer (py/external.py:13-129).

The reference discovers installed ComfyUI packs (bleh, OCS, restart
sampling) at init time and widens its widget domains with their blend
modes/filters. Here the same extensibility is first-class: extensions
register into the live registries below (the port's own), and because node-parameter
validation (sonar_tpu_torch.api.validate) resolves enum domains against these
registries, registered extensions are immediately valid workflow values.

Discovery: ``discover()`` imports every module named in the
``SONAR_TPU_EXTENSIONS`` env var (comma-separated import paths) and calls
its ``sonar_tpu_init(ext)`` hook with this module, mirroring the
reference's per-integration init handlers. The hook and the variable keep
the JAX package's names, so one extension module serves both packages.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Iterable, Sequence


def register_blend_mode(name: str, fn: Callable) -> None:
    """Add a blend function ``fn(a, b, t)`` (bleh-style extension surface);
    delegates to the core registry helper."""
    from ..core.blend import register_blend_mode as _core_register

    _core_register(name, fn)


def register_ffilter_preset(name: str, gains: Sequence[float]) -> None:
    """Add a named frequency-filter gain curve for BlendFilterNoise."""
    from ..noise.blendfilter import FILTER_PRESETS

    FILTER_PRESETS[name] = tuple(float(g) for g in gains)


def register_enhance_mode(name: str, fn: Callable) -> None:
    """Add an enhancement ``fn(t, scale, *, sigma=None)`` for
    BlendFilterNoise."""
    from ..noise.blendfilter import ENHANCE_HANDLERS

    ENHANCE_HANDLERS[name] = fn


def register_quantile_strategy(name: str, fn: Callable) -> None:
    """Add a quantile-normalization outlier handler ``fn(noise, nq, **kw)``."""
    from ..core.normalize import QUANTILE_HANDLERS

    QUANTILE_HANDLERS[name] = fn


def register_noise_type(name: str, factory: Callable) -> None:
    """Add a noise type to the registry (then valid in every noise_type
    widget)."""
    from ..noise import presets

    presets.register_noise_type(name, factory)


def register_sampler(name: str, fn: Callable) -> None:
    from .functions import register_sampler as _reg

    _reg(name, fn)


def register_node(name: str) -> Callable:
    """Decorator: add a node builder under a new node name."""
    from .nodes import register_node as _reg

    return _reg(name)


def discover(modules: Iterable[str] | None = None) -> list[str]:
    """Import extension modules and run their ``sonar_tpu_init(ext)`` hooks.

    ``modules`` defaults to the comma-separated ``SONAR_TPU_EXTENSIONS``
    env var. Returns the list of modules successfully initialized; failures
    are reported and skipped (an extension must never break the host —
    the reference's integration layer has the same contract).
    """
    import sys

    if modules is None:
        raw = os.environ.get("SONAR_TPU_EXTENSIONS", "")
        modules = [m.strip() for m in raw.split(",") if m.strip()]
    loaded = []
    for modname in modules:
        try:
            mod = importlib.import_module(modname)
            hook = getattr(mod, "sonar_tpu_init", None)
            if hook is not None:
                hook(sys.modules[__name__])
            loaded.append(modname)
        except Exception as exc:  # noqa: BLE001 — extension isolation
            print(f"sonar_tpu_torch: extension {modname!r} failed to load: {exc!r}")
    return loaded
