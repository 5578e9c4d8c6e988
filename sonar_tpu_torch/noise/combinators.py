"""The noise combinator algebra (port of ``sonar_tpu.noise.combinators``;
reference py/noise.py:470-2241): all 19 of the JAX package's classes.

A combinator is a :class:`~.base.NoiseItem` whose ``sample`` composes child
items. The children's persistent state lives in this node's state dict, and
child ``i`` is initialised on ``derive_seed(seed, i)``, as the JAX package
folds ``i`` into its key.

The sampler's sigmas are host numbers, so every sigma-conditional choice of
the JAX package (a ``lax.cond``, or both sides computed and one selected
with ``jnp.where``) is a host branch on float32 sigmas: only the chosen side
runs, and a child that does not run keeps its state. The combinators' own
random choices that steer a branch (``RepeatedNoise``'s slot, mode, flips
and roll; ``RandomNoise``'s children) are host integers derived from the
draw's seed by :func:`repeat_choices` and :func:`random_choices`, so a draw
reads nothing back from the card. They cannot reproduce JAX's threefry
choices; a test replaces both with one table. ``ShuffledNoise``'s masks and
permutations are Philox uniforms on the device (kernel B3) and an
``argsort`` there.

On a sharded latent (``NoiseCtx.shard``) every item draws this rank's block
of the whole latent's draw (:mod:`.base`): normalizations pass the shard,
the reductions that span the latent (a guide's shift, a remap's range, a
quantile, a modulation's norms) run on the blocks gathered from the ranks
(``NoiseCtx.on_whole``), and ``PerDimNoise`` along a split dimension and
``ShuffledNoise`` draw the whole latent on every rank and keep their block
(``couples``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..core.normalize import (
    normalize_to_scale,
    normalize_to_scale_adv,
    quantile_normalize,
    scale_noise,
    tquantile,
    tstd,
)
from ..core.rng import derive_seed, seed_from
from ..ops.resample import scale_samples
from ..samplers.ancestral import get_ancestral_step
from ..samplers.guidance import guidance_linear as _guidance_linear
from ..samplers.guidance import guidance_shift
from ..utils.misc import crop_samples, default_device, elementwise_shuffle_by_dim, pattern_break
from .base import NoiseCtx, NoiseItem, draw_whole, quantile_dims

INT32_MAX = 2**31 - 1


def _resolve_blend(fn_or_name):
    if callable(fn_or_name):
        return fn_or_name
    return BLENDING_MODES[fn_or_name]


def _zeros(ctx: NoiseCtx) -> torch.Tensor:
    return torch.zeros(tuple(ctx.shape), dtype=ctx.dtype, device=default_device(ctx.device))


def _host_f32(sigma) -> np.float32:
    """A host sigma (a number, or the largest of a sequence) as float32, the
    JAX package's traced type."""
    return np.float32(np.max(np.asarray(sigma, dtype=np.float64)))


def _as_device(value, ctx: NoiseCtx) -> torch.Tensor:
    """An array the spec holds (numpy or a tensor) on the ctx's device and type."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    return t.to(device=default_device(ctx.device), dtype=ctx.dtype)


def _memo(cache: dict, ctx: NoiseCtx, make):
    """``make()`` once per (shape, type, device) of the ctx, kept in
    ``cache``: the device constants a draw reuses, so that a draw after the
    first copies nothing to the card."""
    key = (tuple(ctx.shape), ctx.dtype, str(default_device(ctx.device)))
    if key not in cache:
        cache[key] = make()
    return cache[key]


class WrapperNoise(NoiseItem):
    """Base for single-child wrappers: handles child state plumbing."""

    CHILD_KEYS: tuple[str, ...] = ("noise",)
    SHARDABLE = True  # draws a rank's block of a sharded latent (module docstring)

    def _children(self) -> dict[str, NoiseItem | None]:
        return {k: getattr(self, k, None) for k in self.CHILD_KEYS}

    def check_dims(self, ctx):
        super().check_dims(ctx)
        if ctx.shard is not None and self.couples(ctx):  # its children draw the whole latent
            ctx = dataclasses.replace(ctx, shape=ctx.global_shape(), shard=None, ref=None)
        for child in self._children().values():
            if child is not None:
                child.check_dims(self.child_ctx(ctx))

    def child_ctx(self, ctx: NoiseCtx) -> NoiseCtx:
        return ctx

    def init_state(self, ctx, seed):
        if ctx.shard is not None and self.couples(ctx):
            ctx = ctx.whole()  # the whole latent's draw, as sample makes it
        cctx = self.child_ctx(ctx)
        return {
            k: (None if c is None else c.init_state(cctx, derive_seed(seed, i)))
            for i, (k, c) in enumerate(self._children().items())
        }

    def child_sample(self, name, ctx, state, seed, sigma, sigma_next, *, normalized):
        child = getattr(self, name)
        noise, cstate = child.sample(
            self.child_ctx(ctx), state[name], seed, sigma, sigma_next,
            normalized=normalized,
        )
        return noise, {**state, name: cstate}


# ---------------------------------------------------------------------------
# CompositeNoise — mask-lerp of two samplers (py/noise.py:470-533)
# ---------------------------------------------------------------------------


class CompositeNoise(WrapperNoise):
    """``dst·(1 - mask) + src·mask``, the mask resized bilinear to the
    latent and tiled over the batch (made once per ctx and device)."""

    CHILD_KEYS = ("dst_noise", "src_noise")

    def __init__(self, factor=1.0, *, dst_noise, src_noise, mask,
                 normalize_dst=None, normalize_src=None, normalize_result=None):
        super().__init__(factor, dst_noise=dst_noise, src_noise=src_noise, mask=mask,
                         normalize_dst=normalize_dst, normalize_src=normalize_src,
                         normalize_result=normalize_result)
        self._masks = {}

    def _prepared_mask(self, ctx):
        def make():
            m = _as_device(self.mask, ctx)
            m = scale_samples(m.reshape((-1, 1) + tuple(m.shape[-2:])), ctx.width, ctx.height,
                              mode="bilinear")
            # on a shard, this rank's rows of the whole batch's tiling
            b0 = 0 if ctx.shard is None else ctx.shard.offset[0]
            batch = ctx.global_shape()[0]
            return m.repeat(-(-batch // m.shape[0]), 1, 1, 1)[b0: b0 + ctx.batch]

        return _memo(self._masks, ctx, make)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        nd = self.get_normalize("normalize_dst", normalized)
        ns_ = self.get_normalize("normalize_src", normalized)
        nr = self.get_normalize("normalize_result", normalized)
        dst, state = self.child_sample("dst_noise", ctx, state, derive_seed(seed, "dst"),
                                       sigma, sigma_next, normalized=nd)
        src, state = self.child_sample("src_noise", ctx, state, derive_seed(seed, "src"),
                                       sigma, sigma_next, normalized=ns_)
        mask = self._prepared_mask(ctx)
        out = dst * (1.0 - mask) + src * mask
        return scale_noise(out, self.factor, normalized=nr, shard=ctx.shard), state


# ---------------------------------------------------------------------------
# GuidedNoise — guidance toward a reference latent (py/noise.py:536-623)
# ---------------------------------------------------------------------------


class GuidedNoise(WrapperNoise):
    """Linear or Euler guidance of the child's noise toward ``ref_latent``
    (resized bicubic to the latent once per ctx and device). Euler's
    ``sigma == sigma_next`` fallback to linear guidance is a host branch;
    its shift statistics come from the exemplar latent (``ctx.ref_like``),
    or from the noise without one."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, ref_latent, guidance_factor=0.5,
                 method="euler", noise=None, normalize_noise=None, normalize_result=None):
        if method not in ("linear", "euler"):
            raise ValueError("Bad method")
        super().__init__(factor, ref_latent=ref_latent, guidance_factor=guidance_factor,
                         method=method, noise=noise, normalize_noise=normalize_noise,
                         normalize_result=normalize_result)
        self._refs = {}

    def _ref(self, ctx):
        def make():
            ref = scale_samples(_as_device(self.ref_latent, ctx), ctx.width, ctx.height,
                                mode="bicubic")
            if ctx.shard is not None and tuple(ref.shape) == ctx.global_shape():
                ref = ctx.block(ref)  # a guide of the whole latent: this rank's block
            return ref

        return _memo(self._refs, ctx, make)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        nn = self.get_normalize("normalize_noise", normalized)
        nr = self.get_normalize("normalize_result", normalized)
        gf = self.guidance_factor
        have_noise = self.noise is not None
        if have_noise:
            noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                             normalized=nn)
        else:
            noise = _zeros(ctx)
        ref = self._ref(ctx)
        lerp = BLENDING_MODES["lerp"]
        s, sn = _host_f32(sigma), _host_f32(sigma_next)
        if self.method == "linear" or s == sn:
            # the shift's mean and std are the whole latent's
            out = ctx.on_whole(lambda n, r: _guidance_linear(n, r, gf, blend=lerp,
                                                             do_shift=have_noise), noise, ref)
        else:
            # guidance_euler with x = the noise (py/noise.py:600-614); the
            # reference passes the exemplar x as `denoised` for the shift
            shift_src = ctx.ref_like()
            if shift_src is None:
                shift_src = noise

            def euler(n, r, src):
                ref_shift = guidance_shift(src, r) if have_noise else r
                d = (n - ref_shift) / float(s if s != 0 else np.float32(1.0))
                return n + d * float(sn - s) * gf

            out = ctx.on_whole(euler, noise, ref, shift_src)
        return scale_noise(out, self.factor, normalized=nr, shard=ctx.shard), state


class ScheduledNoise(WrapperNoise):
    """Sigma-window main/fallback select (py/noise.py:626-678): ``noise``
    while ``end_sigma <= sigma <= start_sigma`` (compared in float32, as the
    JAX package compares its float32 sigma), else ``fallback_noise`` (zeros
    without one)."""

    CHILD_KEYS = ("noise", "fallback_noise")

    def __init__(self, factor=1.0, *, noise, start_sigma=math.inf, end_sigma=0.0,
                 fallback_noise=None, normalize=None):
        super().__init__(
            factor, normalize=normalize,
            noise=noise, fallback_noise=fallback_noise,
            start_sigma=start_sigma, end_sigma=end_sigma,
        )

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        if sigma is None or sigma_next is None:
            raise ValueError("ScheduledNoise requires sigma, sigma_next to be passed")
        normalize = self.get_normalize("normalize", normalized)
        s = np.float32(sigma)
        if np.float32(self.end_sigma) <= s <= np.float32(self.start_sigma):
            noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                             normalized=False)
        elif self.fallback_noise is None:
            noise = _zeros(ctx)
        else:
            noise, state = self.child_sample("fallback_noise", ctx, state, seed, sigma,
                                             sigma_next, normalized=False)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), state


# ---------------------------------------------------------------------------
# RepeatedNoise — cache + recycle with permutation (py/noise.py:681-758)
# ---------------------------------------------------------------------------


def repeat_choices(seed: int, length: int, permute: bool) -> tuple:
    """RepeatedNoise's host draws for one sample (the JAX package's four
    ``randint`` draws): a slot in [0, length), and where the noise may be
    permuted a mode in {0, 1} and two integers in [0, 2^31 - 1); else
    ``None`` for those three. Derived from the draw's seed on the host."""
    slot = derive_seed(seed, "slot") % length
    if not permute:
        return slot, None, None, None
    return (slot, derive_seed(seed, "mode") % 2, derive_seed(seed, "r2") % INT32_MAX,
            derive_seed(seed, "r3") % INT32_MAX)


class RepeatedNoise(WrapperNoise):
    """Draws into a cache of ``repeat_length`` slots while it fills, then
    reuses a random slot (never the last one) until it has been used
    ``max_recycle`` times, and then refills it; reused (or, with
    ``permute="always"``, all) noise is negated, flipped along one or two
    axes or rolled along one. ``counts``, ``filled`` and ``last_idx`` are
    host state; the cache is a tuple of device tensors (a slot is replaced,
    never written in place, so a saved state replays)."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, repeat_length=8, max_recycle=1000,
                 permute="enabled", normalize=None):
        if permute not in ("enabled", "disabled", "always"):
            raise ValueError("Bad permute mode")
        super().__init__(factor, normalize=normalize, noise=noise,
                         repeat_length=repeat_length, max_recycle=max_recycle,
                         permute=permute)

    def init_state(self, ctx, seed):
        st = super().init_state(ctx, seed)
        L = self.repeat_length
        st["cache"] = (_zeros(ctx),) * L
        st["counts"] = (0,) * L
        st["filled"] = 0
        st["last_idx"] = -1
        return st

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        L = self.repeat_length
        filled, counts, last_idx = state["filled"], state["counts"], state["last_idx"]
        ridx, rep_mode, r2, r3 = repeat_choices(seed, L, self.permute != "disabled")
        if ridx == last_idx:
            ridx = (ridx + 1) % L
        idx = filled if filled < L else ridx
        need_fresh = filled < L or counts[idx] >= self.max_recycle
        if need_fresh:
            noise, state = self.child_sample("noise", ctx, state, derive_seed(seed, "gen"),
                                             sigma, sigma_next, normalized=False)
            cache = state["cache"][:idx] + (noise,) + state["cache"][idx + 1:]
        else:
            noise, cache = state["cache"][idx], state["cache"]
        counts = counts[:idx] + ((1 if need_fresh else counts[idx] + 1),) + counts[idx + 1:]
        state = {**state, "cache": cache, "counts": counts, "filled": min(filled + 1, L),
                 "last_idx": idx}
        if self.permute == "always" or (self.permute == "enabled" and not need_fresh):
            nd = noise.ndim
            permute = lambda t: self._permuted(t, rep_mode, r2, r3)  # noqa: E731
            if ctx.splits((r2 % nd, r3 % nd)):  # rolled or flipped across ranks
                noise = ctx.on_whole(permute, noise)
            else:
                noise = permute(noise)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), state

    @staticmethod
    def _permuted(noise, rep_mode, r2, r3):
        nd = noise.ndim
        d1, d2 = r2 % nd, r3 % nd
        if rep_mode == 1:  # roll a random axis by a random amount
            return torch.roll(noise, r3 % noise.shape[d1], dims=d1)
        if r2 <= INT32_MAX // 5:  # 10 %: the noise as it is, or negated
            return -noise if r2 & 1 else noise
        return torch.flip(noise, dims=(d1,) if d2 == d1 else (d1, d2))


# ---------------------------------------------------------------------------
# ModulatedNoise — intensity / frequency / spectral_signum (py/noise.py:763-1019)
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of all elements: a float32 reduction (no TF32 path)."""
    return torch.sqrt(torch.sum(x * x))


def _intensity_modulate(ref, noise, s_noise, sigma_up, intensity, dims):
    std = tstd(ref - ref.mean(), dim=dims, keepdim=True)
    scaling = 1.0 / (std * abs(intensity) + 1.0)
    additive = noise * s_noise * sigma_up
    scaled = additive * scaling + additive
    scaled = scaled * (_norm(additive) / _norm(scaled))
    return scaled * intensity + additive * (1 - intensity)


def _frequency_modulate(ref, noise, s_noise, sigma_up, intensity, dims):
    additive = noise * s_noise * sigma_up
    std = tstd(ref - ref.mean(), dim=dims, keepdim=True)
    scaling = 1.0 / (std * abs(intensity) + 1.0)
    spec = torch.fft.fft2(scaling * additive + additive)
    h, w = ref.shape[-2], ref.shape[-1]
    b = abs(intensity)
    fy = torch.arange(h, device=ref.device, dtype=torch.float32)[:, None] / h
    fx = torch.arange(w, device=ref.device, dtype=torch.float32)[None, :] / w
    hp = 1.0 - torch.exp(-(fy**2 + fx**2) * b**2)
    spec_scaled = torch.abs(spec) * (1.0 + hp) * torch.exp(1j * torch.angle(spec))
    out = torch.real(torch.fft.ifft2(spec_scaled))
    out = out * (_norm(additive) / _norm(out))
    return out * intensity + additive * (1 - intensity)


def _spectral_modulate(ref, noise, s_noise, sigma_up, intensity, dims,
                       spectral_mod_percentile=5.0):
    del ref
    additive = noise * s_noise * sigma_up
    spec = torch.fft.fftn(additive, dim=dims)
    log_amp = torch.log(torch.sqrt(spec.real**2 + spec.imag**2))
    flat = torch.abs(log_amp).reshape(log_amp.shape[0], -1)
    expand = (log_amp.shape[0],) + (1,) * (log_amp.ndim - 1)
    q_lo = tquantile(flat, spectral_mod_percentile * 0.01, dim=1).reshape(expand)
    q_hi = tquantile(flat, 1 - spectral_mod_percentile * 0.01, dim=1).reshape(expand)
    q_max = torch.amax(flat, dim=1).reshape(expand)
    mult_high = torch.where(log_amp > q_hi,
                            1.0 - torch.clamp((log_amp - q_hi) / (q_max - q_hi), max=0.5), 1.0)
    mult_low = torch.where(log_amp < q_lo,
                           1.0 + torch.clamp(1.0 - log_amp / q_lo, max=0.5), 1.0)
    filtered = spec * (mult_low * mult_high) ** intensity
    return torch.real(torch.fft.ifftn(filtered, dim=dims))


_MODULATION_FUNCTIONS = {
    "intensity": _intensity_modulate,
    "frequency": _frequency_modulate,
    "spectral_signum": _spectral_modulate,
}


class ModulatedNoise(WrapperNoise):
    """The child's noise, times the step's ancestral sigma_up, modulated
    against a reference (``ref_latent_opt``, else the exemplar latent
    through ``ctx.ref_like``, else zeros): by the reference's spread
    (intensity), with a high-frequency lift (frequency), or by damping
    spectral outliers (spectral_signum). sigma_up is a host float32."""

    CHILD_KEYS = ("noise",)
    MODULATION_DIMS = ((-3,), (-2, -1), (-3, -2, -1))

    def __init__(self, factor=1.0, *, noise, modulation_type="none",
                 modulation_strength=2.0, modulation_dims=3, ref_latent_opt=None,
                 normalize_result=None, normalize_noise=None, normalize_ref=True):
        if modulation_type != "none" and modulation_type not in _MODULATION_FUNCTIONS:
            raise ValueError("Bad modulation type")
        super().__init__(factor, noise=noise, modulation_type=modulation_type,
                         modulation_strength=modulation_strength,
                         modulation_dims=modulation_dims, ref_latent_opt=ref_latent_opt,
                         normalize_result=normalize_result, normalize_noise=normalize_noise,
                         normalize_ref=normalize_ref)
        self._refs = {}

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        nn = self.get_normalize("normalize_noise", normalized)
        nr = self.get_normalize("normalize_result", normalized)
        nref = self.get_normalize("normalize_ref", normalized)
        if self.modulation_type == "none":
            noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                             normalized=nr or nn)
            return scale_noise(noise, self.factor, normalized=False, shard=ctx.shard), state
        mod_fn = _MODULATION_FUNCTIONS[self.modulation_type]
        dims = self.MODULATION_DIMS[self.modulation_dims - 1]
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=nn)
        _, sigma_up = get_ancestral_step(_host_f32(sigma), _host_f32(sigma_next), eta=1.0)

        def modulate(n, ref):  # its norms, means and spectra span the whole latent
            return mod_fn(scale_noise(ref, normalized=nref), n, 1.0, float(sigma_up),
                          self.modulation_strength, dims)

        if self.ref_latent_opt is not None:  # a reference of the whole latent
            ref = _memo(self._refs, ctx, lambda: _as_device(self.ref_latent_opt, ctx))
            out = ctx.on_whole(lambda n: modulate(n, ref), noise)
        else:
            ref = ctx.ref_like()
            if ref is None:
                ref = _zeros(ctx)
            out = ctx.on_whole(modulate, noise, ref)
        return scale_noise(out, self.factor, normalized=nr, shard=ctx.shard), state


# ---------------------------------------------------------------------------
# RandomNoise — pick mix_count distinct children per call (py/noise.py:1022-1073)
# ---------------------------------------------------------------------------


class MultiChildNoise(NoiseItem):
    """Base for combinators over a list of children (a chain's items)."""

    SHARDABLE = True  # draws a rank's block of a sharded latent (module docstring)

    def __init__(self, factor=1.0, *, items, **kwargs):
        items = (list(items.items) if hasattr(items, "items") and not callable(items.items)
                 else list(items))
        if not items:
            raise ValueError(f"{type(self).__name__} requires at least one noise item")
        super().__init__(factor, items=items, **kwargs)

    def clone(self):
        import inspect

        p = self.cloned_params()
        factor = p.pop("factor")
        p["noise"] = p.pop("items")  # __init__ takes the child list as noise=
        sig = inspect.signature(self.__class__.__init__)
        if not any(m.kind == m.VAR_KEYWORD for m in sig.parameters.values()):
            allowed = set(sig.parameters) - {"self", "factor"}
            p = {k: v for k, v in p.items() if k in allowed}
        return self.__class__(factor, **p)

    def check_dims(self, ctx):
        super().check_dims(ctx)
        for item in self.items:
            item.check_dims(ctx)

    def init_state(self, ctx, seed):
        return tuple(item.init_state(ctx, derive_seed(seed, i))
                     for i, item in enumerate(self.items))


def random_choices(seed: int, n: int, mix: int) -> tuple[int, ...]:
    """RandomNoise's host draw for one sample: ``mix`` distinct child
    indices out of ``n`` (one uniform index when ``mix`` is 1), derived from
    the draw's seed on the host (the JAX package: a permutation prefix, or
    one ``randint``)."""
    if mix == 1 and n > 1:
        return (derive_seed(seed, "pick") % n,)
    keys = [derive_seed(seed, "pick", i) for i in range(n)]
    return tuple(sorted(range(n), key=keys.__getitem__)[:mix])


class RandomNoise(MultiChildNoise):
    """The sum of ``mix_count`` distinct children picked at random each
    draw. Only the picked children run; the others keep their state (as in
    the reference, where an unpicked sampler is never called)."""

    def __init__(self, factor=1.0, *, noise, mix_count=1, normalize=None):
        super().__init__(factor, items=noise, mix_count=mix_count, normalize=normalize)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        n = len(self.items)
        mix = min(self.mix_count, n)
        normalize = self.get_normalize("normalize", normalized or mix > 1)
        chosen = set(random_choices(seed, n, mix))
        gen = derive_seed(seed, "gen")
        total, new_states = None, list(state)
        for i, item in enumerate(self.items):
            if i not in chosen:
                continue
            ni, new_states[i] = item.sample(ctx, state[i], derive_seed(gen, i), sigma,
                                            sigma_next, normalized=False)
            total = ni if total is None else total + ni
        if total is None:  # mix_count 0
            total = _zeros(ctx)
        return scale_noise(total, self.factor, normalized=normalize, shard=ctx.shard), tuple(new_states)


# ---------------------------------------------------------------------------
# ChannelNoise — one child per channel (py/noise.py:1076-1131)
# ---------------------------------------------------------------------------


class ChannelNoise(MultiChildNoise):
    """Child ``c`` draws channel ``c``; with fewer children than channels
    the list wraps, repeats its last child, or leaves the rest zero."""

    def __init__(self, factor=1.0, *, noise, insufficient_channels_mode="wrap",
                 normalize=None):
        if insufficient_channels_mode not in ("wrap", "repeat", "zero"):
            raise ValueError("Bad insufficient_channels_mode")
        super().__init__(factor, items=noise,
                         insufficient_channels_mode=insufficient_channels_mode,
                         normalize=normalize)

    def _per_channel_items(self, ctx):
        c = ctx.channels
        items = list(self.items[:c])
        n = len(items)
        while len(items) < c:
            if self.insufficient_channels_mode == "wrap":
                items.append(self.items[len(items) % n])
            elif self.insufficient_channels_mode == "repeat":
                items.append(self.items[n - 1])
            else:
                items.append(None)  # zero channel
        return items

    def child_ctx(self, ctx, channel: int | None = None):
        """Per-channel ctx; the exemplar latent is sliced to the channel
        (the reference passes x[:, c:c+1] to each child, py/noise.py:1116-1123)."""
        cctx = ctx.with_planes((ctx.shape[0], 1) + tuple(ctx.shape[2:]))
        ref = None
        if channel is not None:
            ref = ctx.ref_like()
            if ref is not None:
                ref = ref[:, channel: channel + 1]
        return dataclasses.replace(cctx, ref=ref)

    def check_dims(self, ctx):
        NoiseItem.check_dims(self, ctx)
        for item in self.items:
            item.check_dims(self.child_ctx(ctx))

    def init_state(self, ctx, seed):
        return tuple(
            None if item is None else item.init_state(self.child_ctx(ctx, i),
                                                      derive_seed(seed, i))
            for i, item in enumerate(self._per_channel_items(ctx)))

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        chunks, new_states = [], []
        for i, item in enumerate(self._per_channel_items(ctx)):
            cctx = self.child_ctx(ctx, i)
            if item is None:
                chunks.append(_zeros(cctx))
                new_states.append(None)
                continue
            ni, st = item.sample(cctx, state[i], derive_seed(seed, i), sigma, sigma_next,
                                 normalized=False)
            chunks.append(ni)
            new_states.append(st)
        noise = torch.cat(chunks, dim=1)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), tuple(new_states)


# ---------------------------------------------------------------------------
# RippleFilteredNoise (py/noise.py:1134-1202)
# ---------------------------------------------------------------------------


class RippleFilteredNoise(WrapperNoise):
    """Scales the noise by ``1 + wave`` along one axis (or the flattened
    trailing axes), the wave a sine or cosine over ``period`` half-turns
    with separate amplitudes for its two signs, rolled by ``roll`` per
    draw (a host counter)."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, dim=-1, flatten=False, mode="sin",
                 amplitude_high=0.25, amplitude_low=0.25, offset=0.0, period=1.0,
                 roll=0.0, normalize_noise=False, normalize=None):
        if mode not in ("sin", "cos", "sin_copysign", "cos_copysign"):
            raise ValueError("Bad mode")
        super().__init__(factor, noise=noise, dim=dim, flatten=flatten, mode=mode,
                         amplitude_high=amplitude_high, amplitude_low=amplitude_low,
                         offset=offset, period=period, roll=roll,
                         normalize_noise=normalize_noise, normalize=normalize)
        self._scalers = {}

    def init_state(self, ctx, seed):
        st = super().init_state(ctx, seed)
        st["counter"] = 0
        return st

    def _scaler(self, ctx, shape=None):
        shape = tuple(ctx.shape if shape is None else shape)
        nd = len(shape)
        dim = self.dim % nd

        def make():
            if self.flatten:
                dim_els = math.prod(shape[dim:])
                scaler_shape = (1,) * dim + tuple(shape[dim:])
            else:
                dim_els = shape[dim]
                scaler_shape = tuple(shape[d] if d == dim else 1 for d in range(nd))
            fn = torch.sin if self.mode.startswith("sin") else torch.cos
            wave = fn(torch.linspace(self.offset, self.offset + math.pi * self.period, dim_els,
                                     dtype=ctx.dtype, device=default_device(ctx.device)))
            return (1.0 + torch.where(wave < 0, wave * self.amplitude_low,
                                      wave * self.amplitude_high)).reshape(scaler_shape)

        key = ctx.with_shape(shape)
        return _memo(self._scalers, key, make), dim

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=self.normalize_noise)
        nd = noise.ndim
        across = ctx.splits(range(self.dim % nd, nd) if self.flatten else (self.dim,))
        # a wave along a split dimension: the whole latent's, then this rank's block
        scaler, dim = self._scaler(ctx, ctx.global_shape() if across else None)
        shift = int(np.float32(self.roll) * np.float32(state["counter"]))
        if shift:
            scaler = torch.roll(scaler, shift, dims=dim)
        if across:
            scaler = ctx.block(scaler.expand(ctx.global_shape()))
        state = {**state, "counter": state["counter"] + 1}
        result = scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard) * scaler
        if self.mode.endswith("_copysign"):
            result = torch.copysign(result, 1.0 - scaler)
        return result, state


# ---------------------------------------------------------------------------
# NormalizeToScaleNoise (py/noise.py:1205-1299)
# ---------------------------------------------------------------------------


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    return x.mean(dim=dims, keepdim=True) if dims is not None else x.mean().reshape(
        (1,) * x.ndim)


class NormalizeToScaleNoise(WrapperNoise):
    """Remaps the noise's range: ``simple`` to [min_negative_value,
    max_positive_value]; ``advanced`` the negative and positive values
    each to their own range (:func:`normalize_to_scale_adv`); per sample
    where ``dims`` is given. Then optional mean and std corrections."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, min_negative_value=-1.0,
                 max_negative_value=0.0, min_positive_value=0.0,
                 max_positive_value=1.0, mode="simple", dims=(),
                 std_dims=None, std_multiplier=0.0, mean_dims=None,
                 mean_multiplier=0.0, normalize_noise=False, normalize=None):
        if mode == "simple":
            if min_negative_value >= max_positive_value:
                raise ValueError(
                    "In simple mode, min_negative_value can't be >= max_positive_value")
        elif mode == "advanced":
            if min_negative_value >= max_negative_value:
                raise ValueError(
                    "In advanced mode, min_negative_value can't be >= max_negative_value")
            if min_positive_value >= max_positive_value:
                raise ValueError(
                    "In advanced mode, min_positive_value can't be >= max_positive_value")
        else:
            raise ValueError("Bad mode")
        super().__init__(factor, noise=noise, mode=mode,
                         min_negative_value=min_negative_value,
                         max_negative_value=max_negative_value,
                         min_positive_value=min_positive_value,
                         max_positive_value=max_positive_value,
                         dims=tuple(dims) if dims else (),
                         std_dims=std_dims, std_multiplier=std_multiplier,
                         mean_dims=mean_dims, mean_multiplier=mean_multiplier,
                         normalize_noise=normalize_noise, normalize=normalize)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=self.normalize_noise)
        # the ranges and corrections span the latent or a sample: the whole latent's
        noise = ctx.on_whole(self._remap, noise)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), state

    def _remap(self, noise):
        per_sample = noise.ndim >= 2 and bool(self.dims)
        if self.mode == "simple":
            if not per_sample:
                noise = normalize_to_scale(noise, self.min_negative_value,
                                           self.max_positive_value, dim=self.dims or None)
            else:
                # per sample (py/noise.py:1282-1284); the JAX package's vmap
                # drops the negative dims, and none left means all of a sample
                dims = tuple(d for d in self.dims if d > 0) or tuple(range(1, noise.ndim))
                noise = normalize_to_scale(noise, self.min_negative_value,
                                           self.max_positive_value, dim=dims)
        else:
            kw = dict(min_pos=self.min_positive_value, max_pos=self.max_positive_value,
                      min_neg=self.min_negative_value, max_neg=self.max_negative_value, dim=())
            noise = (torch.stack([normalize_to_scale_adv(n, **kw) for n in noise])
                     if per_sample else normalize_to_scale_adv(noise, **kw))
        if self.mean_multiplier != 0:
            noise = noise - _mean(noise, self.mean_dims) * self.mean_multiplier
        if self.std_multiplier != 0:
            nstd = (tstd(noise, dim=self.std_dims, keepdim=True) - 1.0) \
                * self.std_multiplier + 1.0
            noise = noise / torch.where(nstd == 0, 1e-07, nstd)
        return noise


# ---------------------------------------------------------------------------
# BlendedNoise (py/noise.py:1302-1407)
# ---------------------------------------------------------------------------


class BlendedNoise(WrapperNoise):
    """Blends two children by ``noise_2_percent``, or by a third child's
    noise remapped to [0, 1] per sample and offset by it."""

    CHILD_KEYS = ("custom_noise_1", "custom_noise_2", "custom_noise_mask")

    def __init__(self, factor=1.0, *, blend_function="lerp", custom_noise_1=None,
                 custom_noise_2=None, custom_noise_mask=None, noise_2_percent=0.5,
                 normalize=None):
        if custom_noise_1 is None and (custom_noise_mask is not None or noise_2_percent != 1):
            raise ValueError(
                "When custom_noise_1 is not attached noise_2_percent must be set to 1")
        if custom_noise_2 is None and (custom_noise_mask is not None or noise_2_percent != 0):
            raise ValueError(
                "When custom_noise_2 is not attached noise_2_percent must be set to 0")
        if custom_noise_mask is None and noise_2_percent == 1 and custom_noise_1 is None:
            custom_noise_1, custom_noise_2 = custom_noise_2, None
            noise_2_percent = 0.0
        super().__init__(factor, normalize=normalize,
                         blend_function=_resolve_blend(blend_function),
                         custom_noise_1=custom_noise_1, custom_noise_2=custom_noise_2,
                         custom_noise_mask=custom_noise_mask,
                         noise_2_percent=noise_2_percent)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        n1, state = self.child_sample("custom_noise_1", ctx, state, derive_seed(seed, 1),
                                      sigma, sigma_next, normalized=False)
        if self.custom_noise_2 is None:
            return scale_noise(n1, self.factor, normalized=normalize, shard=ctx.shard), state
        n2, state = self.child_sample("custom_noise_2", ctx, state, derive_seed(seed, 2),
                                      sigma, sigma_next, normalized=False)
        if self.custom_noise_mask is not None:
            m, state = self.child_sample("custom_noise_mask", ctx, state,
                                         derive_seed(seed, "mask"), sigma, sigma_next,
                                         normalized=False)
            # the reference's normalize_to_scale default: per batch (-3, -2, -1)
            def remap(v):
                return torch.clamp(normalize_to_scale(v, 0.0, 1.0, dim=(-3, -2, -1))
                                   + self.noise_2_percent, 0.0, 1.0)

            t = ctx.on_whole(remap, m) if ctx.splits((-3, -2, -1)) else remap(m)
        else:
            t = float(np.float32(self.noise_2_percent))
        noise = self.blend_function(n1, n2, t)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), state


# ---------------------------------------------------------------------------
# ResizedNoise (py/noise.py:1410-1518)
# ---------------------------------------------------------------------------


class ResizedNoise(WrapperNoise):
    """Draws at another spatial size (absolute or relative in pixels, over
    ``spatial_compression``, or a percentage) and scales or crops the draw
    to the latent's size. The exemplar latent is cropped or scaled to the
    draw's size for the child (``initial_reference``)."""

    CHILD_KEYS = ("custom_noise",)
    MIN_DIMS = 3

    def __init__(self, factor=1.0, *, custom_noise, width=32, height=32,
                 spatial_mode="absolute", spatial_compression=8,
                 upscale_mode="bilinear", downscale_mode="bilinear",
                 crop_mode="center", crop_offset_horizontal=0,
                 crop_offset_vertical=0, downscale_strategy="scale",
                 initial_reference="prefer_crop", normalize=None):
        super().__init__(factor, normalize=normalize, custom_noise=custom_noise,
                         width=width, height=height, spatial_mode=spatial_mode,
                         spatial_compression=spatial_compression,
                         upscale_mode=upscale_mode, downscale_mode=downscale_mode,
                         crop_mode=crop_mode,
                         crop_offset_horizontal=crop_offset_horizontal,
                         crop_offset_vertical=crop_offset_vertical,
                         downscale_strategy=downscale_strategy,
                         initial_reference=initial_reference)

    def _plan(self, ctx):
        """The resize plan: (generation ctx, output transform or None)."""
        xh, xw = ctx.height, ctx.width
        height, width = self.height, self.width
        sc = self.spatial_compression
        if self.spatial_mode != "percentage":
            height //= sc
            width //= sc
        if self.spatial_mode == "absolute":
            nh, nw = int(height), int(width)
        elif self.spatial_mode == "relative":
            nh, nw = int(xh + height), int(xw + width)
        elif self.spatial_mode == "percentage":
            nh, nw = max(1, int(xh * height)), max(1, int(xw * width))
        else:
            raise ValueError("Bad spatial_mode")
        offsh = self.crop_offset_vertical // sc
        offsw = self.crop_offset_horizontal // sc
        if (xh, xw) == (nh, nw):
            return ctx, None
        gen_ctx = ctx.with_shape(tuple(ctx.shape[:-2]) + (nh, nw))
        # x larger than the draw: prefer_crop crops it, prefer_scale scales
        # it down; x smaller: always scaled up (py/noise.py:1466-1494)
        larger = xh >= nh and xw >= nw
        ref = ctx.ref_like()
        if ref is not None:
            if larger and self.initial_reference == "prefer_crop":
                ref = crop_samples(ref, nw, nh, mode=self.crop_mode, offset_width=offsw,
                                   offset_height=offsh)
            else:
                ref = scale_samples(ref, nw, nh, mode=self.downscale_mode if larger
                                    else self.upscale_mode)
        gen_ctx = dataclasses.replace(gen_ctx, ref=ref)
        if larger or xh >= nh or xw >= nw:
            def out(t):
                return scale_samples(t, xw, xh, mode=self.upscale_mode)
        elif self.downscale_strategy == "scale":
            def out(t):
                return scale_samples(t, xw, xh, mode=self.downscale_mode)
        else:
            def out(t):
                return crop_samples(t, xw, xh, mode=self.crop_mode, offset_width=offsw,
                                    offset_height=offsh)
        return gen_ctx, out

    def child_ctx(self, ctx):
        return self._plan(ctx)[0]

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        gen_ctx, out = self._plan(ctx)
        if out is None:
            noise, state = self.child_sample("custom_noise", ctx, state, seed, sigma,
                                             sigma_next, normalized=normalize)
            return noise * self.factor, state
        noise, state = self.child_sample("custom_noise", ctx, state, seed, sigma,
                                         sigma_next, normalized=False)
        return out(scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard)), state


# ---------------------------------------------------------------------------
# LatentOperationFilteredNoise (py/noise.py:1665-1698)
# ---------------------------------------------------------------------------


class LatentOperationFilteredNoise(WrapperNoise):
    """The child's noise through latent operations (``cfg.latent_ops``),
    each called as ``op(latent=noise, sigma=sigma)`` with the host sigma."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, operations=(), normalize_noise=False,
                 normalize=None):
        super().__init__(factor, normalize=normalize, noise=noise,
                         operations=tuple(operations), normalize_noise=normalize_noise)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=self.normalize_noise)
        def run(n):  # an operation may take statistics of the whole latent
            for op in self.operations:
                n = op(latent=n, sigma=sigma)
            return n

        noise = ctx.on_whole(run, noise)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), state


# ---------------------------------------------------------------------------
# QuantileFilteredNoise (py/noise.py:1777-1819)
# ---------------------------------------------------------------------------


class QuantileFilteredNoise(WrapperNoise):
    """The child's noise through :func:`quantile_normalize`."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, quantile=0.85, norm_dim=1,
                 norm_flatten=True, norm_fac=1.0, norm_pow=0.5,
                 strategy="clamp", normalize_noise=False, normalize=None):
        super().__init__(factor, normalize=normalize, noise=noise, quantile=quantile,
                         norm_dim=norm_dim, norm_flatten=norm_flatten,
                         norm_fac=norm_fac, norm_pow=norm_pow, strategy=strategy,
                         normalize_noise=normalize_noise)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=self.normalize_noise)
        noise = ctx.across(quantile_dims(self.norm_dim, self.norm_flatten, noise.ndim),
                           lambda n: quantile_normalize(
                               n, quantile=self.quantile, dim=self.norm_dim,
                               flatten=self.norm_flatten, nq_fac=self.norm_fac,
                               pow_fac=self.norm_pow, strategy=self.strategy), noise)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), state


# ---------------------------------------------------------------------------
# PerDimNoise (py/noise.py:1822-1893)
# ---------------------------------------------------------------------------


def _along(dim: int, nd: int, sl: slice) -> tuple:
    return tuple(sl if d == dim else slice(None) for d in range(nd))


class PerDimNoise(WrapperNoise):
    """Draws the noise chunk by chunk along ``dim``, one child call a chunk
    on ``derive_seed(seed, i)``, the child's state threaded through the
    chunks (config 5's Voronoi z-walk moves ``z`` once a frame). With
    ``shrink_dim`` the child draws chunk-sized; without it, the whole shape
    and the chunk is sliced out."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, dim=0, offset=0, chunk_size=1,
                 shrink_dim=True, normalize_noise=False, normalize=None):
        super().__init__(factor, normalize=normalize, noise=noise, dim=dim,
                         offset=offset, chunk_size=chunk_size, shrink_dim=shrink_dim,
                         normalize_noise=normalize_noise)

    def _dim(self, ctx):
        nd = len(ctx.shape)
        dim = self.dim if self.dim >= 0 else nd + self.dim
        if dim < 0 or dim >= nd:
            raise ValueError("Dimension out of range")
        return dim

    def couples(self, ctx):
        """The child's state is threaded chunk by chunk along ``dim``: along a
        split dimension each rank would start from the initial state."""
        return ctx.splits((self._dim(ctx),))

    def child_ctx(self, ctx):
        if not self.shrink_dim:
            return ctx
        dim = self._dim(ctx)
        if self.offset + self.chunk_size > ctx.shape[dim]:
            raise ValueError("Offset or chunk size incompatible with tensor")
        shape = tuple(self.chunk_size if d == dim else s for d, s in enumerate(ctx.shape))
        # the reference builds the child on the exemplar's window
        # x[offset : offset + chunk_size] along dim (py/noise.py:1857-1864)
        ref = ctx.ref
        if ref is not None and tuple(ref.shape) == tuple(ctx.shape):
            ref = ref[_along(dim, len(shape), slice(self.offset,
                                                    self.offset + self.chunk_size))]
        return dataclasses.replace(ctx.with_planes(shape), ref=ref)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        if ctx.shard is not None and self.couples(ctx):
            return draw_whole(self, ctx, state, seed, sigma, sigma_next, normalized=normalized)
        normalize = self.get_normalize("normalize", normalized)
        dim = self._dim(ctx)
        dim_size, nd = ctx.shape[dim], len(ctx.shape)
        cstate = state["noise"]
        if self.shrink_dim:
            cctx, chunks = self.child_ctx(ctx), []
            for i in range(dim_size):
                ni, cstate = self.noise.sample(cctx, cstate, derive_seed(seed, i), sigma,
                                               sigma_next, normalized=self.normalize_noise)
                chunks.append(ni)
            noise = torch.cat(chunks, dim=dim)[_along(dim, nd, slice(-dim_size, None))]
        else:
            pieces = []
            for ci in range(math.ceil(dim_size / self.chunk_size)):
                full, cstate = self.noise.sample(ctx, cstate, derive_seed(seed, ci), sigma,
                                                 sigma_next, normalized=self.normalize_noise)
                start = ci * self.chunk_size
                stop = min(start + self.chunk_size, dim_size)
                pieces.append(full[_along(dim, nd, slice(start, stop))])
            noise = torch.cat(pieces, dim=dim)
        return scale_noise(noise, self.factor, normalized=normalize, shard=ctx.shard), {**state, "noise": cstate}


# ---------------------------------------------------------------------------
# ShuffledNoise (py/noise.py:1896-2013)
# ---------------------------------------------------------------------------


class ShuffledNoise(WrapperNoise):
    """Shuffles the noise along each of ``dims`` (each line with its
    ``percentages`` probability; ``no_identity`` a cyclic shift), by
    :func:`~..utils.misc.elementwise_shuffle_by_dim` on the device."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, dims=(-1,), percentages=(1.0,),
                 no_identity=False, fork_rng=True, normalize=None):
        if not all(0.0 <= p <= 1.0 for p in percentages):
            raise ValueError("Percentage out of range, must be between 0 and 1")
        super().__init__(factor, normalize=normalize, noise=noise, dims=tuple(dims),
                         percentages=tuple(percentages), no_identity=no_identity,
                         fork_rng=fork_rng)

    def couples(self, ctx):
        """Its mask and permutation uniforms are numbered line by line, in
        the order of the shuffled axis, over the whole latent, and along a
        split dimension elements move between ranks: on any shard the whole
        latent is drawn and shuffled."""
        return True

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        if ctx.shard is not None:
            return draw_whole(self, ctx, state, seed, sigma, sigma_next, normalized=normalized)
        nd = len(ctx.shape)
        dims = tuple(d if d >= 0 else nd + d for d in self.dims)
        if not all(0 <= d < nd for d in dims):
            raise ValueError("Dimension out of range")
        noise, state = self.child_sample("noise", ctx, state, derive_seed(seed, "noise"),
                                         sigma, sigma_next, normalized=normalized)
        if not self.percentages or not dims or all(p == 0 for p in self.percentages):
            return noise, state
        noise = scale_noise(noise, self.factor, normalized=normalized, shard=ctx.shard)
        shuffle, n_p = derive_seed(seed, "shuffle"), len(self.percentages)
        for idx, dim in enumerate(dims):
            noise = elementwise_shuffle_by_dim(
                noise, derive_seed(shuffle, idx), dim=dim,
                prob=self.percentages[idx % n_p], no_identity=self.no_identity)
        return noise, state


# ---------------------------------------------------------------------------
# PatternBreakNoise (py/noise.py:2016-2077)
# ---------------------------------------------------------------------------


class PatternBreakNoise(WrapperNoise):
    """Blends the noise with :func:`~..utils.misc.pattern_break`'s
    scrambled copy by ``percentage``."""

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, detail_level=0.0, percentage=1.0,
                 restore_scale=True, blend_mode="lerp", blend_function=None):
        super().__init__(factor, noise=noise, detail_level=detail_level,
                         percentage=percentage, restore_scale=restore_scale,
                         blend_function=blend_function or BLENDING_MODES[blend_mode])

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        if self.percentage == 0:
            return self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                     normalized=normalized)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=False)
        noise = ctx.on_whole(lambda n: pattern_break(
            n, percentage=self.percentage, detail_level=self.detail_level,
            blend_function=self.blend_function, restore_scale=self.restore_scale), noise)
        return scale_noise(noise, self.factor, normalized=normalized, shard=ctx.shard), state


class CustomNoiseParametersNoise(WrapperNoise):
    """Parameter-override wrapper (py/noise.py:2080-2187).

    - ``frames_to_channels`` folds a 5D (B, C, F, H, W) context into a 4D
      (B, C·F, H, W) one for the child and the draw back;
    - ``ensure_square_aspect_ratio`` draws on the smallest square that
      holds the pixels and crops;
    - ``fix_invalid`` maps NaN to 0 and ±inf to the finite max/min;
    - ``override_dtype`` draws in another type; ``override_device`` is
      accepted and changes nothing (every stream is the same on the CPU and
      the card), nor does ``rng_mode`` (the streams are explicit seeds);
    - ``rng_offset_mode`` ``"add"`` derives the seeds with
      ``rng_state_offset``; ``"override"`` draws from a stream of
      ``rng_state_offset`` alone, a draw counter in the state advancing it,
      as the JAX package carries one.
    """

    CHILD_KEYS = ("noise",)

    def __init__(self, factor=1.0, *, noise, override_dtype=None,
                 override_device=None, frames_to_channels=False,
                 ensure_square_aspect_ratio=False, fix_invalid=False,
                 rng_mode="default", rng_offset_mode="disabled",
                 rng_state_offset=0, normalize=None):
        super().__init__(factor, normalize=normalize, noise=noise,
                         override_dtype=override_dtype,
                         override_device=override_device,
                         frames_to_channels=frames_to_channels,
                         ensure_square_aspect_ratio=ensure_square_aspect_ratio,
                         fix_invalid=fix_invalid, rng_mode=rng_mode,
                         rng_offset_mode=rng_offset_mode,
                         rng_state_offset=rng_state_offset)

    def _folded(self, ctx) -> tuple[tuple[int, ...], int]:
        """The child's shape before the square adjustment, and its number of
        spatial axes."""
        shape = tuple(ctx.shape)
        if len(shape) == 5 and self.frames_to_channels:
            shape = (shape[0], shape[1] * shape[2]) + shape[3:]
        return shape, 1 if len(shape) == 3 else 2

    def child_ctx(self, ctx):
        shape, spatdims = self._folded(ctx)
        ref = ctx.ref
        if ref is not None and shape != tuple(ctx.shape) and tuple(ref.shape) == tuple(ctx.shape):
            ref = ref.reshape(shape)
        if self.ensure_square_aspect_ratio:
            height = 1 if len(shape) == 3 else shape[-2]
            hw = (height * shape[-1]) ** 0.5
            if not float(hw).is_integer():
                hw = math.ceil(hw)
                shape = shape[:-spatdims] + (hw, hw)
        return dataclasses.replace(ctx, shape=shape, dtype=self.override_dtype or ctx.dtype,
                                   ref=ref)

    def init_state(self, ctx, seed):
        if self.rng_offset_mode == "override":
            seed = seed_from(self.rng_state_offset)
        elif self.rng_offset_mode == "add":
            seed = derive_seed(seed, self.rng_state_offset)
        st = super().init_state(ctx, seed)
        if self.rng_offset_mode == "override":
            st = {**st, "_rng_i": 0}
        return st

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        if self.rng_offset_mode == "override":
            seed = derive_seed(seed_from(self.rng_state_offset), state["_rng_i"])
            state = {**state, "_rng_i": state["_rng_i"] + 1}
        elif self.rng_offset_mode == "add":
            seed = derive_seed(seed, self.rng_state_offset)
        cctx = self.child_ctx(ctx)
        noise, state = self.child_sample("noise", ctx, state, seed, sigma, sigma_next,
                                         normalized=False)
        if self.fix_invalid:
            finite = torch.nan_to_num(noise, nan=0.0, posinf=0.0, neginf=0.0)
            noise = torch.nan_to_num(noise, nan=0.0, posinf=math.inf, neginf=-math.inf)
            noise = torch.where(torch.isposinf(noise), ctx.pmax(finite.max()), noise)
            noise = torch.where(torch.isneginf(noise), ctx.pmin(finite.min()), noise)
        if self.ensure_square_aspect_ratio and cctx.shape != tuple(ctx.shape):
            hw_shape, spat = self._folded(ctx)
            hw = hw_shape[-spat:]
            flat = noise.reshape(noise.shape[:-spat] + (-1,))[..., : math.prod(hw)]
            noise = flat.reshape(flat.shape[:-1] + tuple(hw))
        if noise.shape != tuple(ctx.shape):
            noise = noise.reshape(tuple(ctx.shape))
        return scale_noise(noise.to(ctx.dtype), self.factor, normalized=normalize, shard=ctx.shard), state


__all__ = [
    "BlendedNoise",
    "ChannelNoise",
    "CompositeNoise",
    "CustomNoiseParametersNoise",
    "GuidedNoise",
    "LatentOperationFilteredNoise",
    "ModulatedNoise",
    "MultiChildNoise",
    "NormalizeToScaleNoise",
    "PatternBreakNoise",
    "PerDimNoise",
    "QuantileFilteredNoise",
    "RandomNoise",
    "RepeatedNoise",
    "ResizedNoise",
    "RippleFilteredNoise",
    "ScheduledNoise",
    "ShuffledNoise",
    "WrapperNoise",
]
