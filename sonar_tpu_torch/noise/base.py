"""The noise protocol (port of ``sonar_tpu.noise.base``).

A noise *spec* is an immutable config object that knows how to

- ``init_state(ctx, seed) -> state`` — explicit persistent state, and
- ``sample(ctx, state, seed, sigma, sigma_next, normalized) -> (noise, state)``
  — a function of its state, a per-draw seed and the step's sigmas.

``make_noise_sampler`` assembles a spec into one step function plus an
initial state. The state holds the stream seed and a draw counter; each
draw's seed is derived from (seed, counter), so a run that stops and resumes
from the state draws exactly what an uninterrupted run draws.

Normalization contract (py/noise.py:164-196 + 249-257): parents request
normalization of their children via ``normalized``; an item's own tri-state
``normalize`` field overrides the parent's request.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.normalize import scale_noise
from ..core.rng import derive_seed, seed_from


@dataclasses.dataclass(frozen=True)
class NoiseCtx:
    """Static sampling context captured from the exemplar latent."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
    device: Any = None
    sigma_min: float | None = None
    sigma_max: float | None = None
    # The exemplar latent ``x`` the sampler was built from; excluded from
    # equality so NoiseCtx stays usable as a plain config record.
    ref: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def batch(self) -> int:
        return self.shape[0]

    @property
    def channels(self) -> int:
        return self.shape[1]

    @property
    def frames(self) -> int | None:
        return self.shape[-3] if self.ndim == 5 else None

    @property
    def height(self) -> int:
        return self.shape[-2]

    @property
    def width(self) -> int:
        return self.shape[-1]

    def adjusted_shape(self) -> tuple[int, ...]:
        """5D (B,C,F,H,W) folded to (B,C*F,H,W) for 2D-spatial algorithms
        (py/noise_generation.py:182-209)."""
        if self.ndim == 5:
            return (self.batch, self.channels * self.frames, self.height, self.width)
        return self.shape


class NoiseItem:
    """Base spec for every node in a noise-composition tree
    (``CustomNoiseItemBase``, py/noise.py:30-80), as immutable config."""

    MIN_DIMS = 1
    MAX_DIMS = 0

    def __init__(self, factor: float = 1.0, *, normalize: bool | None = None, **kwargs):
        self.factor = factor
        self.normalize = normalize
        self._keys = ("factor", "normalize", *kwargs.keys())
        for k, v in kwargs.items():
            setattr(self, k, v)

    def params(self) -> dict:
        return {k: getattr(self, k) for k in self._keys}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.params().items())
        return f"{self.__class__.__name__}({body})"

    def check_dims(self, ctx: NoiseCtx) -> None:
        if ctx.ndim < self.MIN_DIMS:
            raise ValueError(
                f"{self.__class__.__name__} requires at least {self.MIN_DIMS} "
                f"dimension(s) but got shape {ctx.shape}"
            )
        if self.MAX_DIMS > 0 and ctx.ndim > self.MAX_DIMS:
            raise ValueError(
                f"{self.__class__.__name__} requires at most {self.MAX_DIMS} "
                f"dimension(s) but got shape {ctx.shape}"
            )

    def init_state(self, ctx: NoiseCtx, seed: int):
        """Build this node's persistent state (default: empty)."""
        del ctx, seed
        return ()

    def sample(self, ctx: NoiseCtx, state, seed: int, sigma, sigma_next, *,
               normalized: bool = True):
        raise NotImplementedError

    def apply_factor_normalize(self, noise: torch.Tensor, *, normalized: bool) -> torch.Tensor:
        """The leaf-wrapper semantics of ``NoiseSampler.__call__``
        (py/noise.py:249-257): one scale_noise with this item's factor."""
        eff = self.normalize if self.normalize is not None else normalized
        return scale_noise(noise, self.factor, normalized=bool(eff))


SampleFn = Callable  # (state, sigma, sigma_next) -> (noise, state)


def make_noise_sampler(
    item: NoiseItem,
    shape: tuple[int, ...],
    *,
    dtype=torch.float32,
    device=None,
    sigma_min=None,
    sigma_max=None,
    seed: int | None = None,
    normalized: bool = True,
    ref_latent=None,
) -> tuple[SampleFn, Any]:
    """Build ``(sample_fn, init_state)`` for a noise spec tree.

    ``sample_fn(state, sigma, sigma_next) -> (noise, new_state)`` does not
    mutate ``state``: the draw counter advances in the returned state, so
    repeated calls give independent draws and a saved state replays
    exactly. ``seed`` is an integer (a user seed or one from
    :func:`~sonar_tpu_torch.core.rng.derive_seed`; None → 0).
    """
    ctx = NoiseCtx(shape=tuple(shape), dtype=dtype, device=device,
                   sigma_min=sigma_min, sigma_max=sigma_max, ref=ref_latent)
    item.check_dims(ctx)
    stream = seed_from(seed)
    state0 = {"seed": stream, "counter": 0,
              "node": item.init_state(ctx, derive_seed(stream, "init"))}

    def sample_fn(state, sigma, sigma_next):
        draw_seed = derive_seed(state["seed"], state["counter"])
        noise, node_state = item.sample(ctx, state["node"], draw_seed, sigma,
                                        sigma_next, normalized=normalized)
        return noise.to(dtype), {"seed": state["seed"],
                                 "counter": state["counter"] + 1,
                                 "node": node_state}

    return sample_fn, state0


class NoiseSamplerHandle:
    """Stateful wrapper with the reference's calling convention
    ``ns(sigma, sigma_next) -> noise`` for eager use."""

    def __init__(self, item: NoiseItem, shape, **kwargs):
        self.sample_fn, self.state = make_noise_sampler(item, shape, **kwargs)

    def __call__(self, sigma=None, sigma_next=None):
        noise, self.state = self.sample_fn(self.state, sigma, sigma_next)
        return noise
