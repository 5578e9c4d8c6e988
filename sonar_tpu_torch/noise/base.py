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
statistics. Every built-in item draws so and says ``SHARDABLE = True``; an
item that does not say it (a user's own), or a tree that holds one, raises
``NotImplementedError`` rather than draw another stream. On a shard:

- every Philox draw is taken at its global indices (kernel B3's ``shard=``,
  B4's and B5's ``planes=``), so elementwise items need nothing else;
- a minimum or maximum over the whole latent compares over the ranks
  (:meth:`NoiseCtx.pmax`, :meth:`NoiseCtx.pmin`); a normalization sums over
  them (kernel B2 split); an order statistic (a quantile), a statistic
  that must match the unsharded draw's bits, or an operation along a split
  dimension runs on the whole latent gathered from the ranks' blocks
  (:meth:`NoiseCtx.gather`) and keeps this rank's block of its result
  (:meth:`NoiseCtx.on_whole`);
- an item that threads state or shuffles along a split dimension draws the
  whole latent's noise on every rank and keeps its block
  (:meth:`NoiseItem.couples`, :func:`draw_whole`): the draw is a function
  of the seed, so this is exact.
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
from ..utils.profiling import span


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

    # -- a sharded ctx ----------------------------------------------------------

    def global_shape(self, shape=None) -> tuple[int, ...]:
        """The whole latent's shape of a field of ``shape`` (this ctx's by
        default) that holds this rank's planes, possibly folded (frames into
        channels): the split dimensions take their global sizes."""
        shape = tuple(self.shape if shape is None else shape)
        if self.shard is None:
            return shape
        loc, glob = self.shard.local_shape[:-2], self.shard.global_shape[:-2]
        out, i = [], 0
        for want in shape[:-2]:
            p = g = 1
            while i < len(loc):
                p, g, i = p * loc[i], g * glob[i], i + 1
                if p >= want:
                    break
            if p != want:
                raise NotImplementedError(f"NoiseCtx: a field of {shape} is not the planes "
                                          f"of the sharded latent {self.shard.local_shape}")
            out.append(g)
        if any(glob[j] != 1 for j in range(i, len(loc))):
            raise NotImplementedError(f"NoiseCtx: a field of {shape} drops a split dimension "
                                      f"of {self.shard.local_shape}")
        return tuple(out) + shape[-2:]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole latent's field from this rank's block ``t`` (a field of
        this rank's planes): each rank writes its planes into zeros of the
        whole field and the ranks sum (``all_reduce``; adding zeros is
        exact). ``t`` itself when the ctx is not sharded."""
        if self.shard is None:
            return t
        if t.is_complex():
            return torch.complex(self.gather(t.real), self.gather(t.imag))
        from ..parallel.mesh import all_reduce

        gshape = self.global_shape(t.shape)
        h, w = t.shape[-2:]
        wide = t.dtype if t.dtype in (torch.float32, torch.float64) else torch.float32
        buf = torch.zeros((math.prod(gshape[:-2]), h * w), dtype=wide, device=t.device)
        buf.index_copy_(0, self.shard.plane_index(t.device), t.reshape(-1, h * w).to(wide))
        return all_reduce(buf, self.shard.groups).to(t.dtype).reshape(gshape)

    def block(self, full: torch.Tensor, shape=None) -> torch.Tensor:
        """This rank's block, of ``shape`` (the ctx's by default), of the
        whole latent's field ``full``."""
        if self.shard is None:
            return full
        shape = tuple(self.shape if shape is None else shape)
        h, w = full.shape[-2:]
        planes = full.reshape(-1, h * w).index_select(0, self.shard.plane_index(full.device))
        return planes.reshape(shape[:-2] + (h, w))

    def on_whole(self, fn: Callable, *tensors):
        """``fn`` of the whole latent's fields gathered from ``tensors``
        (this rank's blocks), and this rank's block of its result: GSPMD's
        all-gather for an operation that does not split by rows. ``fn`` of
        the tensors when the ctx is not sharded."""
        if self.shard is None:
            return fn(*tensors)
        return self.block(fn(*(self.gather(t) for t in tensors)), tensors[0].shape)

    def across(self, dims, fn: Callable, *tensors):
        """``fn`` of ``tensors``, on the whole latent (:meth:`on_whole`) where
        it reduces over ``dims`` and one of them is split."""
        return self.on_whole(fn, *tensors) if self.splits(dims) else fn(*tensors)

    def draw(self, draw: Callable, seed, shape, lead: int = 0, **kw):
        """``draw(seed, shape, **kw)``, a Philox draw that takes kernel B3's
        ``shard=``, of a field that holds this ctx's shape after ``lead``
        leading dimensions (rounds) and before any trailing ones (an event):
        on a shard, this rank's slice of the whole field's draw (one slice a
        round where the rounds do not tile into one)."""
        shape = tuple(shape)
        if self.shard is None or math.prod(shape) == 0:
            return draw(seed, shape, **kw)
        own = tuple(self.shape)
        if shape[lead:lead + len(own)] != own:
            raise NotImplementedError(f"NoiseCtx: a draw of {shape} does not hold the "
                                      f"sharded block {own} after {lead} dimensions")
        rounds, trail = math.prod(shape[:lead]), math.prod(shape[lead + len(own):])
        first, run, stride = (v * trail for v in self.field_shard(own))
        whole = math.prod(self.global_shape()) * trail
        if rounds == 1 or (math.prod(own) * trail // run) * stride == whole:
            return draw(seed, shape, shard=(first, run, stride), **kw)
        return torch.stack([draw(seed, shape[lead:], shard=(first + r * whole, run, stride),
                                 **kw) for r in range(rounds)]).reshape(shape)

    def whole(self) -> "NoiseCtx":
        """The unsharded ctx of the whole latent: its shape, and the
        exemplar latent gathered from the ranks' blocks."""
        if self.shard is None:
            return self
        ref = self.ref
        if isinstance(ref, torch.Tensor) and tuple(ref.shape) == tuple(self.shape):
            ref = self.gather(ref.to(default_device(self.device)))
        else:
            ref = None
        return dataclasses.replace(self, shape=self.global_shape(), shard=None, ref=ref)

    def _over(self, dims):
        return self.shard.groups if dims is None else self.shard.groups_over(dims)

    def pmax(self, t: torch.Tensor, dims=None) -> torch.Tensor:
        """``t`` (a maximum over this rank's block, over ``dims`` of the
        latent or all of it) maximised over the ranks that hold the rest."""
        if self.shard is None:
            return t
        from ..parallel.mesh import all_max

        return all_max(t, self._over(dims))

    def pmin(self, t: torch.Tensor, dims=None) -> torch.Tensor:
        """:meth:`pmax` with the minimum."""
        if self.shard is None:
            return t
        from ..parallel.mesh import all_min

        return all_min(t, self._over(dims))

    def splits(self, dims) -> bool:
        """Whether the latent is split along one of ``dims`` (of this ctx)."""
        if self.shard is None:
            return False
        nd = len(self.shape)
        if nd != len(self.shard.local_shape):
            return True  # a folded field: treat any split as crossing it
        return any(d % nd in self.shard.dims for d in dims)

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

    def with_planes(self, shape: tuple[int, ...]) -> "NoiseCtx":
        """:meth:`with_shape` for a field whose unsplit dimensions change
        size (one channel of the latent): the shard follows."""
        shard = None if self.shard is None else self.shard.resized(shape)
        return dataclasses.replace(self, shape=tuple(shape), shard=shard)

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

    def couples(self, ctx: NoiseCtx) -> bool:
        """Whether on ``ctx``'s shard this item ties elements of different
        ranks' blocks together in a way no reduction undoes (state threaded
        or elements moved along a split dimension): it then draws the whole
        latent's noise on every rank and keeps its block (:func:`draw_whole`)."""
        del ctx
        return False

    def apply_factor_normalize(self, noise: torch.Tensor, *, normalized: bool,
                               shard=None) -> torch.Tensor:
        """The leaf-wrapper semantics of ``NoiseSampler.__call__``
        (py/noise.py:249-257): one scale_noise with this item's factor."""
        eff = self.normalize if self.normalize is not None else normalized
        return scale_noise(noise, self.factor, normalized=bool(eff), shard=shard)


SampleFn = Callable  # (state, sigma, sigma_next) -> (noise, state)


def draw_whole(item: NoiseItem, ctx: NoiseCtx, state, seed, sigma, sigma_next, *,
               normalized: bool):
    """``item``'s draw of the whole latent (the unsharded ctx, on every
    rank) and this rank's block of it; ``state`` is the whole draw's."""
    noise, state = item.sample(ctx.whole(), state, seed, sigma, sigma_next,
                               normalized=normalized)
    return ctx.block(noise), state


def quantile_dims(dim, flatten: bool, ndim: int) -> tuple[int, ...]:
    """The dimensions that ``quantile_normalize(dim=, flatten=)`` takes its
    quantile over."""
    if dim is None:
        return tuple(range(ndim))
    return tuple(range(dim % ndim, ndim)) if flatten and ndim > 1 else (dim % ndim,)


def _children(item) -> list:
    found = []

    def walk(v):
        if isinstance(v, NoiseItem):
            found.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    for v in item.params().values():
        walk(v)
    return found


def shardable(item) -> bool:
    """Whether ``item`` and every item under it say ``SHARDABLE``."""
    return bool(getattr(item, "SHARDABLE", False)) and all(
        shardable(c) for c in _children(item))


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
    latent (the ranks' sums between kernel B2's passes). An item that does
    not say ``SHARDABLE = True``, or holds one that does not, raises
    ``NotImplementedError`` here. Every rank of the shard's groups must make
    the same calls: a draw may reduce over the ranks.
    """
    if shard is not None:
        if tuple(shard.global_shape) != tuple(shape):
            raise ValueError(f"make_noise_sampler: shard of {shard.global_shape}, "
                             f"latent {tuple(shape)}")
        if not shardable(item):
            raise NotImplementedError(
                f"noise {getattr(item, 'name', type(item).__name__)!r} "
                f"({type(item).__name__}) cannot draw a rank's shard of a sharded latent: "
                "it, or an item under it, does not say SHARDABLE = True")
        shape = shard.local_shape
    ctx = NoiseCtx(shape=tuple(shape), dtype=dtype, device=default_device(device),
                   sigma_min=sigma_min, sigma_max=sigma_max, ref=ref_latent, shard=shard)
    item.check_dims(ctx)
    stream = seed_from(seed)
    state0 = {"seed": stream, "counter": 0,
              "node": item.init_state(ctx, derive_seed(stream, "init"))}

    def sample_fn(state, sigma, sigma_next):
        with span("sonar.noise"):
            draw_seed = derive_seed(state["seed"], state["counter"])
            noise, node_state = item.sample(ctx, state["node"], draw_seed, sigma,
                                            sigma_next, normalized=normalized)
            noise = noise.to(dtype)
        return noise, {"seed": state["seed"], "counter": state["counter"] + 1,
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
