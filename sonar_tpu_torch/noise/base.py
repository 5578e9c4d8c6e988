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

Sharded latents: a sampler made with ``shard=`` (a
:class:`~sonar_tpu_torch.parallel.LatentShard`) draws this rank's block of
the draw of the whole latent, and normalizes with the whole latent's
statistics. Only the items that say ``SHARDABLE = True`` (gaussian and
pyramid, and a ``NoiseChain`` of such items) draw so; any other raises
``NotImplementedError`` rather than draw another stream.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Callable

import torch

from ..core.normalize import scale_noise
from ..core.rng import derive_seed, seed_from
from ..utils.misc import default_device


@dataclasses.dataclass(frozen=True)
class NoiseCtx:
    """Static sampling context captured from the exemplar latent.
    ``device=None`` means the card (:func:`~..utils.misc.default_device`)."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
    device: Any = None
    sigma_min: float | None = None
    sigma_max: float | None = None
    # The exemplar latent ``x`` the sampler was built from; excluded from
    # equality so NoiseCtx stays usable as a plain config record.
    ref: Any = dataclasses.field(default=None, compare=False, repr=False)
    # Where ``shape`` (this rank's block) lies in the whole latent (a
    # ``parallel.LatentShard``, which holds the global shape), or None.
    shard: Any = None

    def field_shard(self, shape) -> tuple[int, int, int] | None:
        """The element slice (first, run, stride) of the whole latent's draw
        that this rank draws for a field of ``shape``: the latent's planes
        (all dimensions but the last two, possibly folded) of any H × W.
        None when the latent is not sharded."""
        if self.shard is None:
            return None
        shape = tuple(shape)
        if len(shape) < 3 or math.prod(shape[:-2]) != math.prod(self.shape[:-2]):
            raise NotImplementedError(f"NoiseCtx: a field of {shape} is not the planes of "
                                      f"the sharded latent {self.shape}")
        return self.shard.runs(shape[-2], shape[-1])

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

    def with_shape(self, shape: tuple[int, ...]) -> "NoiseCtx":
        return dataclasses.replace(self, shape=tuple(shape))

    def ref_like(self):
        """The exemplar latent conformed to this ctx, or None: unchanged
        when the shapes are equal, bicubic-resized when only H and W differ
        (the reference's interpolate fallback, py/noise.py:582-589), None
        otherwise. It follows the ctx's device and type."""
        if self.ref is None:
            return None
        ref = torch.as_tensor(self.ref).to(device=default_device(self.device),
                                           dtype=self.dtype)
        if tuple(ref.shape) == tuple(self.shape):
            return ref
        if (ref.ndim == self.ndim and ref.ndim >= 3
                and tuple(ref.shape[:-2]) == tuple(self.shape[:-2])):
            from ..ops.resample import scale_samples

            return scale_samples(ref, self.width, self.height, mode="bicubic")
        return None

    def adjusted_shape(self) -> tuple[int, ...]:
        """5D (B,C,F,H,W) folded to (B,C*F,H,W) for 2D-spatial algorithms
        (py/noise_generation.py:182-209)."""
        if self.ndim == 5:
            return (self.batch, self.channels * self.frames, self.height, self.width)
        return self.shape


def fix_output_frames(ctx: NoiseCtx, noise: torch.Tensor) -> torch.Tensor:
    """Unfold a 2D-spatial result of ``adjusted_shape`` back to a 5D ctx."""
    if ctx.ndim == 5 and tuple(noise.shape) != tuple(ctx.shape):
        return noise.reshape(ctx.shape)
    return noise


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

    @staticmethod
    def _clone_value(v):
        """Deep-clone child items inside param values (the reference's
        per-class ``clone_key`` overrides, py/noise.py:62-67, generalized)."""
        if isinstance(v, NoiseItem):
            return v.clone()
        if isinstance(v, list):
            return [NoiseItem._clone_value(i) for i in v]
        if isinstance(v, tuple):
            return tuple(NoiseItem._clone_value(i) for i in v)
        return v

    def cloned_params(self) -> dict:
        return {k: self._clone_value(v) for k, v in self.params().items()}

    def clone(self) -> "NoiseItem":
        p = self.cloned_params()
        factor = p.pop("factor")
        # the base records ``normalize`` for every item, but some subclasses
        # take only normalize_result, normalize_noise, ...: drop what their
        # __init__ does not accept (only ever at its default)
        sig = inspect.signature(self.__class__.__init__)
        if not any(prm.kind == prm.VAR_KEYWORD for prm in sig.parameters.values()):
            allowed = set(sig.parameters) - {"self", "factor"}
            p = {k: v for k, v in p.items() if k in allowed}
        return self.__class__(factor, **p)

    def set_factor(self, factor: float) -> "NoiseItem":
        self.factor = factor
        return self

    def get_normalize(self, k: str, default=None):
        val = getattr(self, k, None)
        return default if val is None else val

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

    def apply_factor_normalize(self, noise: torch.Tensor, *, normalized: bool,
                               shard=None) -> torch.Tensor:
        """The leaf-wrapper semantics of ``NoiseSampler.__call__``
        (py/noise.py:249-257): one scale_noise with this item's factor."""
        eff = self.normalize if self.normalize is not None else normalized
        return scale_noise(noise, self.factor, normalized=bool(eff), shard=shard)


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
    shard=None,
) -> tuple[SampleFn, Any]:
    """Build ``(sample_fn, init_state)`` for a noise spec tree.

    ``sample_fn(state, sigma, sigma_next) -> (noise, new_state)`` does not
    mutate ``state``: the draw counter advances in the returned state, so
    repeated calls give independent draws and a saved state replays
    exactly. ``seed`` is an integer (a user seed or one from
    :func:`~sonar_tpu_torch.core.rng.derive_seed`; None → 0). The draws are
    made on ``device``; ``None`` means the card, never the CPU
    (:func:`~sonar_tpu_torch.utils.misc.default_device`).

    ``shard`` (a :class:`~sonar_tpu_torch.parallel.LatentShard` of the
    latent of ``shape``): each draw is this rank's block of the draw of the
    whole latent, of the shard's local shape, normalized over the whole
    latent (the ranks' sums between kernel B2's passes). Items that cannot
    draw so raise ``NotImplementedError`` here.
    """
    if shard is not None:
        if tuple(shard.global_shape) != tuple(shape):
            raise ValueError(f"make_noise_sampler: shard of {shard.global_shape}, "
                             f"latent {tuple(shape)}")
        if not getattr(item, "SHARDABLE", False):
            raise NotImplementedError(
                f"noise {getattr(item, 'name', type(item).__name__)!r} "
                f"({type(item).__name__}) cannot draw a rank's shard of a sharded latent "
                "yet: only gaussian and pyramid do, and chains of them")
        shape = shard.local_shape
    ctx = NoiseCtx(shape=tuple(shape), dtype=dtype, device=default_device(device),
                   sigma_min=sigma_min, sigma_max=sigma_max, ref=ref_latent, shard=shard)
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
    ``ns(sigma, sigma_next) -> noise`` for eager use. Keyword arguments
    are :func:`make_noise_sampler`'s (``device=None`` means the card)."""

    def __init__(self, item: NoiseItem, shape, **kwargs):
        self.sample_fn, self.state = make_noise_sampler(item, shape, **kwargs)

    def __call__(self, sigma=None, sigma_next=None):
        noise, self.state = self.sample_fn(self.state, sigma, sigma_next)
        return noise
