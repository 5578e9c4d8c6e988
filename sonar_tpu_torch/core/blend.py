"""Blending-mode registry (port of ``sonar_tpu.core.blend``).

The reference's three modes (py/utils.py:17-21) plus the extras the bleh
pack supplies, all with signature ``f(a, b, t)``, ``t`` a number or a
broadcastable tensor.
"""

from __future__ import annotations

from typing import Callable

import torch


def _lerp(a, b, t):
    # torch.lerp semantics, in this order of operations: a + (b - a) * t
    return a + (b - a) * t


def _inject(a, b, t):
    return a + b * t


def _subtract_b(a, b, t):
    return a - b * t


def _slerp(a, b, t, *, eps: float = 1e-8):
    """Spherical lerp treating the full tensors as vectors (flattened)."""
    an = torch.sqrt(torch.sum(a * a)) + eps
    bn = torch.sqrt(torch.sum(b * b)) + eps
    dot = torch.clamp(torch.sum((a / an) * (b / bn)), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = torch.abs(so) > 1e-6
    one = torch.ones_like(so)
    so_safe = torch.where(safe, so, one)
    wa = torch.where(safe, torch.sin((1.0 - t) * omega) / so_safe, (1.0 - t) * one)
    wb = torch.where(safe, torch.sin(t * omega) / so_safe, t * one)
    return wa * a + wb * b


BLENDING_MODES: dict[str, Callable] = {
    "lerp": _lerp,
    "inject": _inject,
    "subtract_b": _subtract_b,
    "a_only": lambda a, b, t: a * t,
    "b_only": lambda a, b, t: b * t,
    "subtract": lambda a, b, t: (a - b) * t,
    "multiply": lambda a, b, t: _lerp(a, a * b, t),
    "difference": lambda a, b, t: _lerp(a, torch.abs(a - b), t),
    "maximum": lambda a, b, t: _lerp(a, torch.maximum(a, b), t),
    "minimum": lambda a, b, t: _lerp(a, torch.minimum(a, b), t),
    "slerp": _slerp,
}


def register_blend_mode(name: str, fn: Callable) -> None:
    BLENDING_MODES[name] = fn


def blend(name: str) -> Callable:
    """Look up a blend function by name with a helpful error."""
    try:
        return BLENDING_MODES[name]
    except KeyError:
        valid = ", ".join(sorted(BLENDING_MODES))
        raise ValueError(f"Unknown blend mode {name!r}; valid: {valid}") from None


def blend_scalar(a: float, b: float, t: float, *, blend_function=None,
                 clamp_function=None) -> float:
    """Scalar blend used by schedule interpolation (py/utils.py:33-56); a
    blend function runs on float32 CPU scalars, as the JAX package runs it
    on float32 arrays."""
    if blend_function is None:
        val = a * (1.0 - t) + b * t
    else:
        val = float(blend_function(*(torch.tensor(v, dtype=torch.float32)
                                     for v in (a, b, t))))
    return clamp_function(val) if clamp_function is not None else val
