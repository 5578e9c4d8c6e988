"""Momentum ("Sonar") state machine (port of ``sonar_tpu.samplers.momentum``,
reference py/sonar.py:70-320).

The history is a state dict ``{"hd": tensor, "has": bool}``. The loop runs
on the host and the step index and sigmas are host numbers there, so every
gate (step windows, ``has``) is a Python bool and the selects it drives are
Python branches: none of them waits for the card.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any

import torch

from ..core.blend import blend
from .ancestral import to_d


class HistoryType(str, Enum):
    ZERO = "zero"
    RAND = "rand"
    SAMPLE = "sample"
    SAMPLE_NORM = "sample_norm"


class GuidanceType(str, Enum):
    LINEAR = "linear"
    EULER = "euler"


class MomentumMode(str, Enum):
    CLASSIC = "classic"
    NEW = "new"
    DENOISED = "denoised"


def _coerce(enum_cls, val):
    if isinstance(val, enum_cls):
        return val
    if isinstance(val, str):
        try:
            return enum_cls[val.strip().upper()]
        except KeyError:
            valid = ", ".join(enum_cls.__members__)
            raise ValueError(
                f"Bad value {val!r} for {enum_cls.__name__}, must be one of: {valid}"
            ) from None
    raise TypeError(f"Bad parameter type for {enum_cls.__name__}: {val!r}")


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """py/sonar.py:32-37. ``latent`` is the reference latent (tensor)."""

    guidance_type: GuidanceType = GuidanceType.LINEAR
    factor: float = 0.01
    start_step: int = 1
    end_step: int = 9999
    latent: Any = None

    def __post_init__(self):
        object.__setattr__(self, "guidance_type", _coerce(GuidanceType, self.guidance_type))


@dataclasses.dataclass(frozen=True)
class SonarConfig:
    """py/sonar.py:46-67 — defaults match exactly."""

    momentum: float = 0.95
    momentum_hist: float = 0.75
    direction: float = 1.0
    momentum_start_step: int = 0
    momentum_end_step: int = 9999
    always_update_history: bool = True
    momentum_mode: MomentumMode = MomentumMode.NEW
    init: HistoryType = HistoryType.ZERO
    noise_type: str | None = None
    custom_noise: Any = None
    rand_init_noise_type: str | None = None
    rand_init_noise_multiplier: float = 1.0
    guidance: GuidanceConfig | None = None
    blend_mode: str = "lerp"
    momentum_blend_mode: str | None = None
    history_blend_mode: str | None = None
    guidance_blend_mode: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "momentum_mode", _coerce(MomentumMode, self.momentum_mode))
        object.__setattr__(self, "init", _coerce(HistoryType, self.init))
        if isinstance(self.guidance, dict):
            object.__setattr__(self, "guidance", GuidanceConfig(**self.guidance))

    def updated(self, ext: dict | None) -> "SonarConfig":
        """YAML-override merge (py/sonar.py:104-131); a shallow field copy,
        so the guidance latent and custom noise are shared, not copied."""
        if not ext:
            return self
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d.update(ext)
        return SonarConfig(**d)

    def _blend(self, name_field: str):
        return blend(getattr(self, name_field) or self.blend_mode)

    @property
    def momentum_blend(self):
        return self._blend("momentum_blend_mode")

    @property
    def history_blend(self):
        return self._blend("history_blend_mode")

    @property
    def guidance_blend(self):
        return self._blend("guidance_blend_mode")

    @property
    def history_ratios(self):
        """(hd_ratio, hd_scale, md_scale) — py/sonar.py:208-219."""
        direction = self.direction
        momentum_hist = self.momentum_hist
        hd_scale = (
            1.0 + abs(direction) * (1 - momentum_hist)
            if direction < 0
            else 2.0 - direction
        )
        return momentum_hist, hd_scale, direction


# ---------------------------------------------------------------------------
# Functional history state
# ---------------------------------------------------------------------------


def init_momentum_state(x: torch.Tensor) -> dict:
    return {"hd": torch.zeros_like(x), "has": False}


def check_step(cfg: SonarConfig, step: int, *, is_history: bool = False) -> bool:
    """py/sonar.py:221-225."""
    if is_history and cfg.always_update_history:
        return True
    return cfg.momentum_start_step <= step <= cfg.momentum_end_step


def _init_hist(cfg: SonarConfig, state, x, denoised, sigma, step, rand_init):
    """py/sonar.py:169-206 — set history on the first qualifying step."""
    if cfg.init == HistoryType.ZERO:
        return state
    if state["has"] or not check_step(cfg, step, is_history=True):
        return state
    if cfg.init in (HistoryType.SAMPLE, HistoryType.SAMPLE_NORM):
        cand = x if cfg.momentum_mode != MomentumMode.DENOISED else denoised
        if cfg.init == HistoryType.SAMPLE_NORM:
            cand = cand / sigma
    elif cfg.init == HistoryType.RAND:
        if rand_init is None:
            raise ValueError("Sonar: RAND history init requires a rand_init tensor")
        cand = rand_init
        if cfg.rand_init_noise_multiplier != 1:
            cand = cand * cfg.rand_init_noise_multiplier
    else:
        raise ValueError("Sonar sampler: bad history type")
    return {"hd": cand, "has": True}


def _update_hist(cfg: SonarConfig, state, momentum_d, step):
    """py/sonar.py:227-236."""
    if cfg.momentum_hist == 1 or not check_step(cfg, step, is_history=True):
        return state
    if state["has"]:
        hd_ratio, hd_scale, md_scale = cfg.history_ratios
        hd = cfg.history_blend(momentum_d * md_scale, state["hd"] * hd_scale, hd_ratio)
    else:
        hd = momentum_d
    return {"hd": hd, "has": True}


def momentum_mix(cfg: SonarConfig, state, item, sigma, *, is_denoised: bool = False,
                 momentum=None):
    """py/sonar.py:238-260."""
    momentum = cfg.momentum if momentum is None else momentum
    mode = cfg.momentum_mode
    if momentum == 1 or ((mode == MomentumMode.DENOISED) != is_denoised):
        return item
    if not state["has"]:
        return item
    history = state["hd"] * sigma if is_denoised else state["hd"]
    return cfg.momentum_blend(history, item, momentum)


def get_momentum_denoised(cfg: SonarConfig, state, x, denoised, sigma, *, step,
                          momentum=None, update_history: bool = True, rand_init=None):
    """py/sonar.py:262-283 → (momentum_denoised, new_state)."""
    md = momentum_mix(cfg, state, denoised, sigma, is_denoised=True, momentum=momentum)
    if update_history:
        state = _init_hist(cfg, state, x, denoised, sigma, step, rand_init)
        state = _update_hist(cfg, state, denoised / sigma, step)
    return (md if check_step(cfg, step) else denoised), state


def get_momentum_d(cfg: SonarConfig, state, x, denoised, sigma, *, step,
                   momentum=None, d=None, update_history: bool = True, rand_init=None):
    """py/sonar.py:285-307 → (momentum_d, new_state).

    Reference quirk preserved: the ``momentum`` argument only gates the
    momentum==1 early-out — the actual mix always uses ``cfg.momentum``
    (py/sonar.py:303 calls momentum_mix WITHOUT forwarding it), so DPM++
    SDE's halved momentum never reaches the blend.
    """
    momentum = cfg.momentum if momentum is None else momentum
    mode = cfg.momentum_mode
    d = to_d(x, sigma, denoised) if d is None else d
    if momentum == 1 or mode == MomentumMode.DENOISED:
        return d, state
    momentum_d = momentum_mix(cfg, state, d, sigma, is_denoised=False)
    if update_history:
        state = _init_hist(cfg, state, x, denoised, sigma, step, rand_init)
        state = _update_hist(
            cfg, state, d if mode == MomentumMode.NEW else momentum_d, step
        )
    return (momentum_d if check_step(cfg, step) else d), state


def momentum_step(cfg: SonarConfig, state, x, denoised, sigma, sigma_down, *, step,
                  rand_init=None):
    """py/sonar.py:309-320 → (x', new_state). Kernel B1 fuses this chain
    (with the noise injection) for the default config family."""
    dt = sigma_down - sigma
    denoised, state = get_momentum_denoised(
        cfg, state, x, denoised, sigma, step=step, rand_init=rand_init
    )
    momentum_d, state = get_momentum_d(
        cfg, state, x, denoised, sigma, step=step, rand_init=rand_init
    )
    return momentum_d * dt + x, state
