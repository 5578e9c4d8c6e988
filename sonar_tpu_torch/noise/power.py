"""Power-spectrum noise subsystem (port of ``sonar_tpu.noise.power``;
reference: py/nodes/powernoise.py:56-554).

- :class:`PowerFilter` — band-pass · 1/f^alpha gain surface in rfft space,
  built on an oversampled fftshifted grid with rotation / stretch / p-norm
  shaping, gaussian band edges, recursive composition, and RMS/flat-mix
  normalization.
- :func:`build_channel_mixer` / :func:`apply_channel_mixer` —
  channel-correlation mixing via an LDL-factored correlation matrix applied
  as a C×C matmul over flattened pixels.
- :class:`PowerNoiseItem` — samples directly in the rfft domain (complex
  randn) or via Brownian noise in the spatial domain when ``time_brownian``.
- :class:`PowerFilterNoiseItem` — same pipeline over arbitrary inner noise.

The filter surface and the mixer matrix are pure functions of the
configuration and the shape: they are computed on the host in float64 numpy
(this module's own copy of that code) and kept as device tensors, one per
(filter, shape, device) and per (mixer, device, dtype), so a draw costs no
host grid and no copy to the card. The per-draw work is one
``torch.fft.rfft2`` · filter · ``irfft2`` (library FFTs, as they are XLA ops
in the JAX package), the optional (C×C)@(C×BHW) product, and
``scale_noise`` (kernel B2). The gaussians (two per rfft-domain draw, one
per Brownian level) are the port's Philox stream (kernel B3).

The FFT libraries take no bfloat16, so for a bfloat16 or float16 latent
the draw, the Brownian path and the filtering run in float32 and the result
is cast to the latent's type where the JAX package casts
(``astype(ctx.dtype)`` before the channel mixer).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from ..core.normalize import scale_noise
from ..core.rng import derive_seed
from ..kernels.hwrng import philox_randn
from ..utils.misc import default_device, work_dtype
from .base import NoiseCtx, NoiseItem
from .brownian import endpoint_increment, endpoint_state


def _bilinear_resize_ac(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=True bilinear (host-side, float64)."""
    in_h, in_w = arr.shape
    ys = np.linspace(0, in_h - 1, out_h)
    xs = np.linspace(0, in_w - 1, out_w)
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = arr[np.ix_(y0, x0)]
    b = arr[np.ix_(y0, x1)]
    c = arr[np.ix_(y1, x0)]
    d = arr[np.ix_(y1, x1)]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx


@dataclasses.dataclass(frozen=True)
class PowerFilter:
    """Band-pass · 1/f^alpha rfft gain surface (powernoise.py:107-294)."""

    min_freq: float = 0.0
    max_freq: float = 0.7071
    stretch: float = 1.0
    rotate: float = 0.0
    pnorm: float = 2.0
    alpha: float = 0.0
    scale: float = 1.0
    rel_bw: float = 0.125
    oversample: int = 4
    compose_with: "PowerFilter | None" = None
    compose_mode: str = "max"

    def __post_init__(self):
        object.__setattr__(self, "max_freq", max(self.max_freq, self.min_freq))

    def clone(self) -> "PowerFilter":
        return self  # frozen — safe to share

    @staticmethod
    def compose(a: np.ndarray, b: np.ndarray, compose_mode: str = "max") -> np.ndarray:
        cf = {
            "max": np.maximum,
            "min": np.minimum,
            "add": np.add,
            "sub": np.subtract,
            "mul": np.multiply,
        }.get(compose_mode, np.maximum)
        return np.clip(cf(a, b), 0.0, None)

    @staticmethod
    def normalize(op: np.ndarray, shape, mix: float = 1.0,
                  normalization_factor: float = 1.0) -> np.ndarray:
        """Lerp toward RMS-1 gain, then toward flat by (1-mix)
        (powernoise.py:174-194)."""
        height, width = shape[-2:]
        hbins = width // 2 + 1
        if mix < 1.0:
            flat = np.ones((height, hbins))
            if mix <= 0.0:
                return flat
        if normalization_factor != 0:
            rms = math.sqrt(float(np.mean(op**2)))
            op = op * (1.0 + (1.0 / rms - 1.0) * normalization_factor)
        if mix < 1.0:
            op = flat + (op - flat) * mix
        return op

    def build(self, shape, override_oversample: int | None = None,
              composed: bool = True) -> np.ndarray:
        """(H, W//2+1) gain surface for a spatial shape (powernoise.py:196-266)."""
        oversample = (
            override_oversample if override_oversample is not None else self.oversample
        )
        height, width = shape[-2:]
        hbins = width // 2 + 1
        # oversampled fftshifted rfft2 frequency grid as complex coords
        re = np.linspace(0, 0.5, oversample * hbins)[None, :]
        im = np.linspace(-(height // 2) / height, ((height - 1) // 2) / height,
                         oversample * height)[:, None]
        fc = re + 1j * im
        if abs(self.rotate) >= 1e-3:
            fc = fc * np.exp(1j * math.radians(self.rotate))
        if self.stretch > 1.0:
            fc = fc.real * self.stretch + 1j * fc.imag
        else:
            fc = fc.real + 1j * (fc.imag / self.stretch)
        if abs(self.pnorm - 2.0) < 1e-3:
            d = np.abs(fc)
        else:
            d = (np.abs(fc.real) ** self.pnorm + np.abs(fc.imag) ** self.pnorm) ** (
                1.0 / self.pnorm
            )
        op = np.empty_like(d)
        m_hp = d >= self.min_freq
        m_lp = d < self.max_freq
        m_band = m_hp & m_lp
        with np.errstate(divide="ignore"):
            op[m_band] = d[m_band] ** (-self.alpha)
        m_above = ~m_lp
        op[m_above] = self.max_freq ** (-self.alpha) * np.exp(
            -((d[m_above] - self.max_freq) ** 2) / (self.rel_bw * self.max_freq) ** 2
        )
        if self.min_freq > 0.0:
            m_below = ~m_hp
            op[m_below] = self.min_freq ** (-self.alpha) * np.exp(
                -((d[m_below] - self.min_freq) ** 2)
                / (self.rel_bw * self.min_freq) ** 2
            )
        op = _bilinear_resize_ac(op, height, hbins)
        op = np.roll(op, -(height // 2), axis=-2)  # ifftshift
        if self.alpha > 0:
            op[0, 0] = 0.0  # gain → inf at DC for alpha > 0
        if self.scale != 1.0:
            op = op * self.scale
        if composed and self.compose_with is not None:
            return self.compose(
                op,
                self.compose_with.build(shape, override_oversample=override_oversample),
                self.compose_mode,
            )
        return op


def build_channel_mixer(channel_count: int, common_mode: float | None,
                        channel_correlation) -> np.ndarray | None:
    """Symmetric correlation matrix from lower-tri entries, LDL-factored and
    row-normalized (powernoise.py:56-87). Host-side numpy/scipy, cached per
    parameter set; an identity mixer (e.g. the default common_mode=0.0)
    returns None so the per-draw matmul is skipped entirely."""
    if common_mode is None:
        return None
    return _build_channel_mixer_cached(channel_count, float(common_mode),
                                       _correlations(channel_correlation))


def _correlations(channel_correlation) -> tuple:
    """The lower-triangle entries as a tuple, from a sequence or a
    comma-separated string."""
    if isinstance(channel_correlation, str):
        channel_correlation = [
            float(v) for v in (s.strip() for s in channel_correlation.split(","))
            if v
        ]
    return tuple(channel_correlation)


@lru_cache(maxsize=64)
def _build_channel_mixer_cached(c: int, common_mode: float,
                                channel_correlation: tuple) -> np.ndarray | None:
    corr = np.asarray(channel_correlation, np.float64)
    n_corr = c * (c - 1) // 2
    corr = corr[:n_corr]
    corr = np.concatenate([
        corr * common_mode,
        np.full((n_corr - corr.size,), common_mode),
    ])
    m = np.eye(c)
    il, jl = np.tril_indices(c, k=-1)
    m[il, jl] = corr
    m = m + np.tril(m, -1).T
    from scipy.linalg import ldl

    lu, dd, _perm = ldl(m, lower=True)
    dc = np.diag(dd).copy()
    mixer = lu.copy()
    np.fill_diagonal(mixer, 1.0)
    mixer = mixer * np.sqrt(np.clip(dc, 0.0, None))[None, :]
    mixer = mixer / np.linalg.norm(mixer, axis=1, keepdims=True)
    if np.allclose(mixer, np.eye(c), atol=1e-12):
        return None  # numerically identity — skip the per-draw matmul
    return mixer


def _mixer_tensor(mixer: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.as_tensor(mixer, dtype=dtype, device=device)


@lru_cache(maxsize=64)
def _cached_mixer_tensor(c: int, common_mode: float, channel_correlation: tuple,
                         device: str, dtype) -> torch.Tensor | None:
    mixer = _build_channel_mixer_cached(c, common_mode, channel_correlation)
    return None if mixer is None else _mixer_tensor(mixer, device, dtype)


def apply_channel_mixer(noise: torch.Tensor, mixer) -> torch.Tensor:
    """``mixer`` is the (C, C) matrix of :func:`build_channel_mixer` (numpy)
    or the same as a tensor on ``noise``'s device; None passes through."""
    if mixer is None:
        return noise
    b, c, h, w = noise.shape
    if not isinstance(mixer, torch.Tensor):
        mixer = _mixer_tensor(mixer, noise.device, noise.dtype)
    mixed = mixer.to(noise.dtype) @ noise.swapaxes(0, 1).reshape(c, -1)
    return mixed.reshape(c, b, h, w).swapaxes(1, 0)


@lru_cache(maxsize=64)
def _filter_tensor(power_filter: PowerFilter, mix: float, norm_factor: float, h: int,
                   w: int, device: str) -> torch.Tensor:
    """The normalized (H, W//2+1) gain surface as a float32 device tensor,
    built once per (filter, shape, device)."""
    shape = (h, w)
    surface = PowerFilter.normalize(power_filter.build(shape), shape, mix=mix,
                                    normalization_factor=norm_factor)
    return torch.as_tensor(surface, dtype=torch.float32, device=device)


class PowerNoiseItem(NoiseItem):
    """Direct rfft-domain power noise (powernoise.py:297-454)."""

    MIN_DIMS = 4
    MAX_DIMS = 4
    SHARDABLE = True  # draws a rank's block of a sharded latent (base module docstring)

    def __init__(self, factor=1.0, *, power_filter: PowerFilter | None = None,
                 mix=1.0, common_mode=0.0, channel_correlation="1, 1, 1, 1, 1, 1",
                 time_brownian=False, filter_norm_factor=1.0, normalize=None,
                 **filter_kwargs):
        if power_filter is None:
            fargs = {
                k: filter_kwargs.pop(k)
                for k in ("min_freq", "max_freq", "stretch", "rotate", "pnorm",
                          "alpha", "rel_bw", "oversample", "scale")
                if k in filter_kwargs
            }
            power_filter = PowerFilter(**fargs)
        super().__init__(factor, normalize=normalize, power_filter=power_filter,
                         mix=mix, common_mode=common_mode,
                         channel_correlation=channel_correlation,
                         time_brownian=time_brownian,
                         filter_norm_factor=filter_norm_factor, **filter_kwargs)

    def make_filter(self, shape, oversample=None) -> np.ndarray:
        return PowerFilter.normalize(
            self.power_filter.build(shape, override_oversample=oversample),
            shape, mix=self.mix,
            normalization_factor=self.filter_norm_factor,
        )

    def filter_tensor(self, ctx: NoiseCtx) -> torch.Tensor:
        """:meth:`make_filter` for the context's shape, on its device."""
        return _filter_tensor(self.power_filter, float(self.mix),
                              float(self.filter_norm_factor), ctx.height, ctx.width,
                              str(default_device(ctx.device)))

    def init_state(self, ctx, seed):
        if self.time_brownian:
            if ctx.sigma_min is None or ctx.sigma_max is None:
                raise ValueError(
                    "time correlated brownian mode is valid only for stochastic samplers"
                )
            return endpoint_state(ctx, seed, dtype=work_dtype(ctx.dtype))
        return {}

    def _mixer(self, ctx):
        if self.common_mode is None:
            return None
        return _cached_mixer_tensor(ctx.channels, float(self.common_mode),
                                    _correlations(self.channel_correlation),
                                    str(default_device(ctx.device)), ctx.dtype)

    def _filtered(self, ctx, noise_or_rfft, filter_rfft, *, is_spatial: bool):
        h, w = ctx.height, ctx.width
        if is_spatial:
            rfft = torch.fft.rfft2(noise_or_rfft.to(work_dtype(noise_or_rfft.dtype)),
                                   norm="ortho")
        else:
            rfft = noise_or_rfft
        noise = torch.fft.irfft2(rfft * filter_rfft, s=(h, w), norm="ortho")
        return apply_channel_mixer(noise.to(ctx.dtype), self._mixer(ctx))

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        eff = self.normalize if self.normalize is not None else normalized
        filter_rfft = self.filter_tensor(ctx)
        if self.time_brownian:
            noise, state = endpoint_increment(ctx, state, sigma, sigma_next,
                                              dtype=work_dtype(ctx.dtype))
            out = self._filtered(ctx, noise, filter_rfft, is_spatial=True)
        else:
            shape = tuple(ctx.shape[:-1]) + (ctx.width // 2 + 1,)
            device = default_device(ctx.device)
            kw = {} if ctx.shard is None else {"shard": ctx.field_shard(shape)}
            rfft = torch.complex(philox_randn(derive_seed(seed, 0), shape, device=device, **kw),
                                 philox_randn(derive_seed(seed, 1), shape, device=device, **kw))
            out = self._filtered(ctx, rfft, filter_rfft, is_spatial=False)
        return scale_noise(out, self.factor, normalized=bool(eff), shard=ctx.shard), state


class PowerFilterNoiseItem(PowerNoiseItem):
    """Power filter over arbitrary inner noise (powernoise.py:471-554):
    always rfft2 → filter → irfft2 on the inner sampler's output."""

    def __init__(self, factor=1.0, *, noise, normalize_noise=None,
                 normalize_result=None, **kwargs):
        super().__init__(factor, normalize=normalize_result, noise=noise,
                         normalize_noise=normalize_noise, **kwargs)

    def check_dims(self, ctx):
        super().check_dims(ctx)
        self.noise.check_dims(ctx)

    def init_state(self, ctx, seed):
        return {"inner": self.noise.init_state(ctx, derive_seed(seed, 0))}

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize_noise = self.get_normalize("normalize_noise", False)
        normalize_result = self.get_normalize("normalize", normalized)
        noise, st = self.noise.sample(ctx, state["inner"], seed, sigma, sigma_next,
                                      normalized=bool(normalize_noise))
        out = self._filtered(ctx, noise, self.filter_tensor(ctx), is_spatial=True)
        return (
            scale_noise(out, self.factor, normalized=bool(normalize_result), shard=ctx.shard),
            {**state, "inner": st},
        )


def rfft2_to_fft2(x: torch.Tensor) -> torch.Tensor:
    """Hermitian-symmetry reconstruction of the full fft for previews
    (powernoise.py:457-468)."""
    height, width = x.shape[-2:]
    x_r = torch.roll(x, height // 2, dims=-2)
    x_l = x_r[..., 1 : -1 if width & 1 else None]
    x_l = torch.flip(torch.conj(x_l), dims=(-2, -1))
    if height & 1 == 0:
        x_l = torch.roll(x_l, 1, dims=-2)
    return torch.cat((x_l, x_r), dim=-1)
