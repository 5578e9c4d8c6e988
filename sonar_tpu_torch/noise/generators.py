"""Noise generators (port of ``sonar_tpu.noise.generators``; reference
py/noise_generation.py): all fifteen of the JAX package's
``GENERATOR_CLASSES``.

Every draw goes through the Philox stream of :mod:`..kernels.hwrng` (kernel
B3 on the card, its plain version on the CPU), seeded from the per-draw
seed it is handed, so there is no global RNG state and one seed gives the
same noise on both devices. Sub-draws take seeds from
:func:`~sonar_tpu_torch.core.rng.derive_seed`, as the JAX package folds keys
(Student-t and Laplace are transforms of Philox uniforms,
:mod:`..core.rng`). The FFT generators (``green_test``, ``onef``) use
PyTorch's FFTs, as they are XLA ops in the JAX package.

The pyramids take their kernel (B4 or B5) whenever its gate, a pure
function of the configuration, holds (``*_supported`` in
:mod:`..kernels.fused_pyramid`); on a CPU tensor the kernel's wrapper runs
its plain version. Otherwise they take the composed path, Philox levels
through :func:`~sonar_tpu_torch.ops.resample.scale_samples`, as the JAX
package does with threefry.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..core.normalize import scale_noise, tquantile, tstd
from ..core.rng import derive_seed, draw_laplace, draw_t
from ..kernels.fused_pyramid import (
    fused_downscale_pyramid,
    fused_downscale_supported,
    fused_pyramid,
    fused_pyramid_supported,
)
from ..kernels.hwrng import philox_rand, philox_randn
from ..ops.resample import scale_samples
from ..utils.misc import default_device, work_dtype
from .base import NoiseCtx, NoiseItem, fix_output_frames
from .brownian import endpoint_increment, endpoint_state


def _device(ctx: NoiseCtx) -> torch.device:
    """The context's device; one that names none runs on the card."""
    return default_device(ctx.device)


def _shard_kw(ctx: NoiseCtx, shape) -> dict:
    """B3's ``shard=`` for a field of ``shape`` under a sharded ctx, else nothing."""
    return {} if ctx.shard is None else {"shard": ctx.field_shard(shape)}


def _planes_kw(ctx: NoiseCtx) -> dict:
    """B4's and B5's ``planes=`` for the latent's planes under a sharded ctx."""
    return {} if ctx.shard is None else {"planes": ctx.shard.plane_runs()}


def _bislerp_couples(mode: str, ctx: NoiseCtx) -> bool:
    """``bislerp`` slerps each pixel's vector across the channels (a 5-D
    latent's frames folded into them): where a channel or frame dimension is
    split, that vector spans ranks."""
    return mode == "bislerp" and ctx.splits(range(1, ctx.ndim - 2))


def _lattice_shard(ctx: NoiseCtx, h: int, w: int):
    """B3's ``shard=`` for a field of ``h × w`` planes per channel (the
    latent's planes without the batch, e.g. Perlin's lattice, drawn once for
    every batch row): None where the channels are whole on every rank."""
    sh = ctx.shard
    if sh is None or all(d == 0 for d in sh.dims):
        return None
    from ..parallel.mesh import LatentShard

    return LatentShard(sh.global_shape[1:], sh.offset[1:], sh.local_shape[1:]).runs(h, w)


class Generator(NoiseItem):
    """Leaf noise generator spec.

    Config fields: algorithm params (see ``ng_params``) plus
    ``gen_normalized`` (tri-state internal output_hook control),
    ``force_normalize``, ``normalize_dims`` — py/noise_generation.py:110-118.
    """

    name = "unknown"
    DEFAULT_NORMALIZED = True  # class default for the internal output hook
    MIN_DIMS = 1
    MAX_DIMS = 0
    SHARDABLE = True  # draws a rank's block of a sharded latent (base module docstring)

    def __init__(self, factor: float = 1.0, *, normalize: bool | None = None, **kwargs):
        merged = dict(self.ng_params())
        extra = {k: v for k, v in kwargs.items() if k not in merged}
        merged.update({k: v for k, v in kwargs.items() if k in merged})
        super().__init__(factor, normalize=normalize, **merged)
        self.options = extra
        self._keys = (*self._keys, "options")

    @classmethod
    def ng_params(cls) -> dict:
        return {
            "gen_normalized": None,
            "force_normalize": None,
            "normalize_dims": None,
        }

    def clone(self):
        p = self.cloned_params()
        factor = p.pop("factor")
        opts = p.pop("options", {})
        return self.__class__(factor, **p, **opts)

    # -- helpers -------------------------------------------------------------
    def randn(self, ctx: NoiseCtx, seed: int, shape=None, dtype=None):
        shape = tuple(shape) if shape is not None else ctx.adjusted_shape()
        return philox_randn(seed, shape, device=_device(ctx), dtype=dtype or ctx.dtype,
                            **_shard_kw(ctx, shape))

    def rand(self, ctx: NoiseCtx, seed: int, shape=None, dtype=None):
        shape = tuple(shape) if shape is not None else ctx.adjusted_shape()
        return philox_rand(seed, shape, device=_device(ctx), dtype=dtype or ctx.dtype,
                           **_shard_kw(ctx, shape))

    # -- protocol ------------------------------------------------------------
    def generate(self, ctx: NoiseCtx, state, seed, sigma, sigma_next):
        raise NotImplementedError

    def output_hook(self, noise, *, internal_default: bool, shard=None):
        gen_norm = (
            self.gen_normalized if self.gen_normalized is not None else internal_default
        )
        return scale_noise(
            noise,
            normalized=bool(gen_norm)
            and (self.force_normalize is None or self.force_normalize is True),
            normalize_dims=self.normalize_dims,
            shard=shard,
        )

    def hooked(self, ctx, state, seed, sigma, sigma_next, *, internal_default=None):
        """Nested-generator entry point: class-default internal hook."""
        d = self.DEFAULT_NORMALIZED if internal_default is None else internal_default
        if ctx.shard is not None and self.couples(ctx):
            # the whole latent's draw on every rank, and this rank's block
            noise, state = self.generate(ctx.whole(), state, seed, sigma, sigma_next)
            noise = ctx.block(noise, ctx.shape if noise.ndim == ctx.ndim
                              else ctx.adjusted_shape())
        else:
            noise, state = self.generate(ctx, state, seed, sigma, sigma_next)
        return self.output_hook(noise, internal_default=d, shard=ctx.shard), state

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        # Item-layer path: internal hook off (py/noise.py:220-231), one
        # scale_noise with the factor at this level (py/noise.py:249-257).
        noise, state = self.hooked(ctx, state, seed, sigma, sigma_next,
                                   internal_default=False)
        noise = self.apply_factor_normalize(noise, normalized=normalized, shard=ctx.shard)
        return noise.to(ctx.dtype), state


class GaussianGenerator(Generator):
    """py/noise_generation.py:252-260."""

    name = "gaussian"
    DEFAULT_NORMALIZED = False

    def generate(self, ctx, state, seed, sigma, sigma_next):
        return self.randn(ctx, seed, shape=ctx.shape), state


class UniformGenerator(Generator):
    """(rand - sub_fac) * mul_fac + mean_fac (py/noise_generation.py:496-514)."""

    name = "uniform"
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"sub_fac": 0.5, "mul_fac": 3.46, "mean_fac": 0.0}

    def generate(self, ctx, state, seed, sigma, sigma_next):
        n = self.rand(ctx, seed, shape=ctx.shape)
        return (n - self.sub_fac) * self.mul_fac + self.mean_fac, state


class BrownianGenerator(Generator):
    """Brownian-tree-style sigma-correlated noise (py/noise_generation.py:263-286).

    The only sigma-consuming base generator. The state carries the seed of
    the bridge chosen at init, so every (sigma, sigma_next) query addresses
    the same underlying Brownian path, and the last endpoint."""

    name = "brownian"
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"levels": 16}

    def init_state(self, ctx, seed):
        return endpoint_state(ctx, seed)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        del seed  # path identity comes from the init-time seed
        return endpoint_increment(ctx, state, sigma, sigma_next, levels=self.levels)


def perlin_noise(
    seed: int,
    grid_shape: tuple[int, int],
    out_shape: tuple[int, int],
    batch_size: int = 1,
    blend: Callable | None = None,
    dtype=torch.float32,
    *,
    device,
    shard=None,
) -> torch.Tensor:
    """Classic grid-gradient Perlin (py/noise_generation.py:300-476).

    Random angles on the (grid+1)² lattice (Philox uniforms times 2π); four
    corner gradients per cell; smoothstep blend of the corner dot products.
    Broadcasting instead of torch unfold, as the JAX package: the same
    corner order (TL, TR, BL, BR) and (x, y) component layout. ``shard``
    draws a slice of the lattice's angles (kernel B3's): the
    ``batch_size`` planes are then a rank's block of a larger lattice.
    """
    blend = blend if blend is not None else BLENDING_MODES["lerp"]
    gh, gw = grid_shape
    oh, ow = out_shape
    bh, bw = oh // gh, ow // gw
    if oh != bh * gh:
        raise ValueError(f"Output height {oh} must be divisible by grid height {gh}")
    if ow != bw * gw:
        raise ValueError(f"Output width {ow} must be divisible by grid width {gw}")
    angle = philox_rand(seed, (batch_size, gh + 1, gw + 1), device=device, dtype=dtype,
                        **({} if shard is None else {"shard": shard})) * (2.0 * math.pi)
    # gradient components, last dim = (x, y)
    grad = torch.stack((torch.cos(angle), torch.sin(angle)), dim=-1)
    corners_v = (grad[:, :-1, :-1], grad[:, :-1, 1:], grad[:, 1:, :-1], grad[:, 1:, 1:])
    # in-cell positions, last dim = (x, y): (bh, bw, 2)
    px = (torch.arange(bw, dtype=dtype, device=angle.device) + 0.5) / bw
    py = (torch.arange(bh, dtype=dtype, device=angle.device) + 0.5) / bh
    pos = torch.stack(torch.meshgrid(px, py, indexing="xy"), dim=-1)
    pos = pos.reshape(1, bh, bw, 1, 1, 2)

    def step(t):
        return t * t * (3.0 - 2.0 * t)

    def corners(v, offset):
        # (B,1,1,gh,gw,2) · (1,bh,bw,1,1,2) → (B,bh,bw,gh,gw): x term + y term
        v = v.reshape(batch_size, 1, 1, gh, gw, 2)
        return (v[..., 0] * (pos[..., 0] - offset[0])
                + v[..., 1] * (pos[..., 1] - offset[1]))

    v_tl, v_tr, v_bl, v_br = corners_v
    step_x = step(pos[..., 0])
    step_y = step(pos[..., 1])
    row0 = blend(corners(v_tl, (0.0, 0.0)), corners(v_tr, (1.0, 0.0)), step_x)
    row1 = blend(corners(v_bl, (0.0, 1.0)), corners(v_br, (1.0, 1.0)), step_x)
    noise = blend(row0, row1, step_y)
    # (B,bh,bw,gh,gw) → (B, gh*bh, gw*bw) cell-major interleave
    return noise.permute(0, 3, 1, 4, 2).reshape(batch_size, gh * bh, gw * bw)


class PerlinOldGenerator(Generator):
    """py/noise_generation.py:289-493, with the grid_shape = (height,
    attr-width) quirk of line 485 kept for parity."""

    name = "perlin_old"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "div_fac": 2.0,
            "iterations": 2,
            "blend_mode": "lerp",
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        blend = BLENDING_MODES[self.blend_mode]
        noise = self.rand(ctx, derive_seed(seed, "base")) / self.div_fac
        channels, height, width = noise.shape[1:]
        for i in range(self.iterations):
            noise = noise + perlin_noise(
                derive_seed(seed, i),
                (height, ctx.width),  # reference quirk: attr width as grid w
                (height, width),
                batch_size=channels,
                blend=blend,
                dtype=noise.dtype,
                device=noise.device,
                shard=_lattice_shard(ctx, height + 1, ctx.width + 1),
            )
        return fix_output_frames(ctx, noise), state


def _size_ladder_highres(h: int, w: int, iterations: int, schedule_seed: int):
    """Build-time random resize ladder for highres_pyramid
    (py/noise_generation.py:544-555): r ~ U[2,4) per iter, sizes grow as
    h*(r^i) capped at 15x; stop after the cap is hit."""
    rng = np.random.default_rng(schedule_seed)
    rs = rng.random(iterations) * 2 + 2
    sizes = []
    ch, cw = h, w
    for i in range(iterations):
        r = float(rs[i])
        ch, cw = min(h * 15, int(ch * (r**i))), min(w * 15, int(cw * (r**i)))
        sizes.append((ch, cw))
        if ch >= h * 15 or cw >= w * 15:
            break
    return sizes


def _size_ladder_pyramid(h: int, w: int, iterations: int, schedule_seed: int):
    """Build-time ladder for pyramid (py/noise_generation.py:626-648):
    sizes shrink as max(1, size/(r^i)); stop at 1."""
    rng = np.random.default_rng(schedule_seed)
    sizes = []
    ch, cw = h, w
    for i in range(iterations):
        r = float(rng.random(1)[0] * 2 + 2)
        cw, ch = max(1, int(cw / (r**i))), max(1, int(ch / (r**i)))
        sizes.append((ch, cw))
        if cw == 1 or ch == 1:
            break
    return sizes


class HighresPyramidGenerator(Generator):
    """py/noise_generation.py:517-564: an inner base (uniform by default)
    plus ever larger gaussian levels, each downscaled to the latent."""

    name = "highres_pyramid"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "discount": 0.7,
            "upscale_mode": "bilinear",
            "iterations": 4,
            "noise_generator": None,
            "normalize_noise": False,
            "schedule_seed": 0,
        }

    def couples(self, ctx):
        return _bislerp_couples(self.upscale_mode, ctx)

    def _inner(self):
        if self.noise_generator is not None:
            return self.noise_generator
        return UniformGenerator(gen_normalized=self.normalize_noise)

    def init_state(self, ctx, seed):
        return self._inner().init_state(ctx, seed)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b, c, h, w = ctx.adjusted_shape()
        base, state = self._inner().hooked(ctx, state, derive_seed(seed, "inner"),
                                           sigma, sigma_next)
        noise = base.reshape(b, c, h, w)
        sizes = _size_ladder_highres(h, w, self.iterations, self.schedule_seed)
        draw = derive_seed(seed, "draw")
        if fused_downscale_supported(sizes, h, w, self.upscale_mode):
            # levels >= 2x the output per axis: only their tapped samples
            # are drawn (kernel B5), the oversized levels never exist
            coefs = [self.discount**i for i in range(len(sizes))]
            noise = fused_downscale_pyramid(draw, (b, c, h, w), sizes, coefs,
                                            self.upscale_mode, base=noise, **_planes_kw(ctx))
            return fix_output_frames(ctx, noise), state
        for i, (sh, sw) in enumerate(sizes):
            big = self.randn(ctx, derive_seed(draw, i), (b, c, sh, sw), noise.dtype)
            noise = noise + scale_samples(big, w, h, mode=self.upscale_mode) * (
                self.discount**i)
        return fix_output_frames(ctx, noise), state


class PyramidOldGenerator(Generator):
    """Deterministic 2^i upscale ladder, std 0.5^i, nearest-exact downscale
    (py/noise_generation.py:567-606). 'Generates noise ~60x the latent
    size'; kernel B5 draws only the samples the downscale taps."""

    name = "pyramid_old"
    MIN_DIMS = 4
    MAX_DIMS = 5
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "discount": 0.8,
            "iterations": 5,
            "upscale_mode": "nearest-exact",
        }

    def couples(self, ctx):
        return _bislerp_couples(self.upscale_mode, ctx)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b, c, h, w = ctx.adjusted_shape()
        sizes = [(h * 2 ** (i + 1), w * 2 ** (i + 1)) for i in range(self.iterations)]
        if fused_downscale_supported(sizes, h, w, self.upscale_mode):
            coefs = [(0.5**i) * self.discount**i for i in range(self.iterations)]
            noise = fused_downscale_pyramid(seed, (b, c, h, w), sizes, coefs,
                                            self.upscale_mode, device=_device(ctx),
                                            **_planes_kw(ctx))
            return fix_output_frames(ctx, noise), state
        noise = torch.zeros((b, c, h, w), dtype=ctx.dtype, device=_device(ctx))
        for i, (sh, sw) in enumerate(sizes):
            big = self.randn(ctx, derive_seed(seed, i), (b, c, sh, sw)) * (0.5**i)
            noise = noise + scale_samples(big, w, h, mode=self.upscale_mode) * (
                self.discount**i)
        return fix_output_frames(ctx, noise), state


class PyramidGenerator(Generator):
    """Whitaker multi-resolution noise (py/noise_generation.py:609-649)."""

    name = "pyramid"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "discount": 0.7,
            "upscale_mode": "bilinear",
            "iterations": 10,
            "schedule_seed": 0,
        }

    def couples(self, ctx):
        return _bislerp_couples(self.upscale_mode, ctx)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b, c, h, w = ctx.adjusted_shape()
        sizes = _size_ladder_pyramid(h, w, self.iterations, self.schedule_seed)
        if fused_pyramid_supported(sizes, h, w, self.upscale_mode):
            noise = fused_pyramid(seed, (b, c, h, w), sizes, self.discount,
                                  self.upscale_mode, device=_device(ctx), **_planes_kw(ctx))
            return fix_output_frames(ctx, noise), state
        noise = self.randn(ctx, derive_seed(seed, "base"), (b, c, h, w))
        for i, (sh, sw) in enumerate(sizes):
            small = self.randn(ctx, derive_seed(seed, "draw", i), (b, c, sh, sw))
            noise = noise + scale_samples(small, w, h, mode=self.upscale_mode) * (
                self.discount**i)
        return fix_output_frames(ctx, noise), state


class StudentTGenerator(Generator):
    """StudentT(loc, scale, df) + per-batch abs-quantile clamp + sqrt-compress
    (py/noise_generation.py:652-677)."""

    name = "studentt"
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "loc": 0.0,
            "scale": 0.2,
            "df": 1.0,
            "quantile_fac": 0.75,
            "pow_fac": 0.5,
            "nq_fac": 1.0,
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = self.loc + self.scale * draw_t(seed, self.df, ctx.shape, ctx.dtype,
                                               device=_device(ctx),
                                               **_shard_kw(ctx, ctx.shape))

        def row_quantile(v):  # a batch row's |quantile|, on the whole row
            flat = torch.abs(v.reshape(v.shape[0], -1))
            nq = tquantile(flat, self.quantile_fac, dim=-1) * self.nq_fac
            return nq.reshape((v.shape[0],) + (1,) * (v.ndim - 1)).expand(v.shape)

        if ctx.splits(range(1, noise.ndim)):  # a row spans ranks
            nq = ctx.on_whole(row_quantile, noise)
        else:
            nq = row_quantile(noise)
        noise = torch.clamp(noise, -nq, nq)
        return torch.copysign(torch.abs(noise) ** self.pow_fac, noise), state


class GreenTestGenerator(Generator):
    """FFT 1/sqrt(power) shaping with sqrt-radial power
    (py/noise_generation.py:680-704). The std is taken of the complex
    inverse FFT (ddof 1, as ``jnp.std`` of a complex array)."""

    name = "green_test"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "scale_fac": 1.0,
            "x_pow": 2,
            "y_pow": 2,
            "power_base": 1.0,
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = self.randn(ctx, seed)
        noise = noise.to(work_dtype(noise.dtype))
        h, w = ctx.height, ctx.width
        scale = self.scale_fac / (w * h)
        fy = torch.fft.fftfreq(h, device=noise.device)[:, None] ** self.y_pow
        fx = torch.fft.fftfreq(w, device=noise.device) ** self.x_pow
        power = torch.sqrt(fy + fx)
        power[0, 0].fill_(self.power_base)  # a fill: assigning a number copies it to the card
        spec = torch.fft.fft2(noise) / torch.sqrt(power).to(torch.complex64)
        out = torch.fft.ifft2(spec)
        # the std of the whole latent's draw: on a shard, of the gathered blocks
        out = out * (scale / tstd(ctx.gather(out)))
        return fix_output_frames(ctx, out.real.to(ctx.dtype)), state


class PinkOldGenerator(Generator):
    """Admittedly-wrong scalar-scaled randn (py/noise_generation.py:707-717)."""

    name = "pink_old"

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"alpha": 2.0, "k": 1.0, "freq": 1.0}

    def generate(self, ctx, state, seed, sigma, sigma_next):
        spectral_density = self.k / self.freq**self.alpha
        return self.randn(ctx, seed, shape=ctx.shape) * spectral_density, state


class PowerOldGenerator(Generator):
    """Admittedly-wrong historical power noise (py/noise_generation.py:
    1259-1287): uniform noise scaled by a per-first-dim spectral density
    k/i^alpha, then standardized per (H, W)."""

    name = "power_old"
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"alpha": 2.0, "k": 1.0}

    def generate(self, ctx, state, seed, sigma, sigma_next):
        b = ctx.shape[0]
        noise = self.rand(ctx, seed, shape=ctx.shape)
        b0 = 0 if ctx.shard is None else ctx.shard.offset[0]  # the global batch rows
        freq = torch.arange(b0 + 1, b0 + b + 1, dtype=ctx.dtype, device=noise.device).reshape(
            (b,) + (1,) * (len(ctx.shape) - 1))
        noise = noise * (self.k / freq**self.alpha)
        mean = noise.mean(dim=(-2, -1), keepdim=True)
        std = tstd(noise, dim=(-2, -1), keepdim=True)
        return (noise - mean) / torch.where(std == 0, 1.0, std), state


class OneFGenerator(Generator):
    """1/f^alpha spectrum shaping (py/noise_generation.py:720-759). The
    reference's ``fftn`` spans the batch and channel axes too, but its gain
    is a function of (H, W) alone, so the transform along those axes cancels
    and the shaping is each plane's ``fft2``: the same values to float32
    rounding, and a rank's block of a sharded latent is shaped on its own
    planes."""

    name = "onef"
    MIN_DIMS = 4
    MAX_DIMS = 5

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "alpha": 2.0,
            "k": 1.0,
            "hfac": 1.0,
            "wfac": 1.0,
            "base_power": 1.0,
            "use_sqrt": True,
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = self.randn(ctx, seed)
        noise = noise.to(work_dtype(noise.dtype))
        h, w = ctx.height, ctx.width
        freq_x = torch.fft.fftfreq(h, self.hfac, device=noise.device)
        freq_y = torch.fft.fftfreq(w, self.wfac, device=noise.device)
        fx, fy = torch.meshgrid(freq_x, freq_y, indexing="ij")
        power = (fx**2 + fy**2) ** (-self.alpha / 2.0)
        if self.k != 0:
            power = self.k / power
        power[0, 0].fill_(self.base_power)  # a fill: assigning a number copies it to the card
        power = power[None, None].to(torch.complex64)
        spec = torch.fft.fft2(noise)
        spec = spec / (torch.sqrt(power) if self.use_sqrt else power)
        out = torch.fft.ifft2(spec).real.to(ctx.dtype)
        return fix_output_frames(ctx, out), state


class PowerLawGenerator(Generator):
    """noise(or sign)·|noise|^alpha with optional amax division
    (py/noise_generation.py:762-786)."""

    name = "powerlaw"

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "alpha": 2.0,
            "div_max_dims": None,
            "use_sign": False,
            "use_div_max_abs": True,
        }

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = self.randn(ctx, seed, shape=ctx.shape)
        modulation = torch.abs(noise) ** self.alpha
        noise = (torch.sign(noise) if self.use_sign else noise) * modulation
        if self.div_max_dims is not None:
            dims = tuple(self.div_max_dims)
            peak = torch.amax(torch.abs(noise) if self.use_div_max_abs else noise, dim=dims,
                              keepdim=True)
            noise = noise / ctx.pmax(peak, dims)  # over the ranks that split ``dims``
        return noise, state


class LaplacianGenerator(Generator):
    """randn/div_fac + Laplace(loc, scale) (py/noise_generation.py:789-802).
    Unlike gaussian, uniform and studentt, it keeps the base class's
    normalized default: its internal hook normalizes, as the reference's."""

    name = "laplacian"

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {"loc": 0.0, "scale": 1.0, "div_fac": 4.0}

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = self.randn(ctx, derive_seed(seed, 0), shape=ctx.shape) / self.div_fac
        lap = self.loc + self.scale * draw_laplace(derive_seed(seed, 1), ctx.shape,
                                                   ctx.dtype, device=_device(ctx),
                                                   **_shard_kw(ctx, ctx.shape))
        return noise + lap, state


class MixedGenerator(Generator):
    """Sum of member generators with optional transforms and an output fn
    (py/noise_generation.py:212-249). Members keep their class-default
    internal normalization."""

    name = "mixed"

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "mix_name": "mixed_noise",
            "noise_mix": (),
            "output_fun": None,
        }

    def _members(self):
        out = []
        for item in self.noise_mix:
            gen, transform = (item, None) if isinstance(item, Generator) else item
            out.append((gen, transform))
        return out

    def check_dims(self, ctx):
        for gen, _t in self._members():
            gen.check_dims(ctx)

    def init_state(self, ctx, seed):
        return tuple(gen.init_state(ctx, derive_seed(seed, i))
                     for i, (gen, _t) in enumerate(self._members()))

    def generate(self, ctx, state, seed, sigma, sigma_next):
        noise = None
        new_states = []
        for i, (gen, transform) in enumerate(self._members()):
            n, st = gen.hooked(ctx, state[i], derive_seed(seed, i), sigma, sigma_next)
            new_states.append(st)
            if transform is not None:
                n = transform(n) if callable(transform) else n * transform
            noise = n if noise is None else noise + n
        if self.output_fun is not None:
            out = self.output_fun
            noise = out(noise) if callable(out) else noise * out
        return noise, tuple(new_states)


GENERATOR_CLASSES: dict[str, type[Generator]] = {
    cls.name: cls
    for cls in (
        GaussianGenerator,
        UniformGenerator,
        BrownianGenerator,
        PerlinOldGenerator,
        HighresPyramidGenerator,
        PyramidOldGenerator,
        PyramidGenerator,
        StudentTGenerator,
        GreenTestGenerator,
        PinkOldGenerator,
        PowerOldGenerator,
        OneFGenerator,
        PowerLawGenerator,
        LaplacianGenerator,
        MixedGenerator,
    )
}
