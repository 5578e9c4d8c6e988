"""Scatternet-filtered noise (port of ``sonar_tpu.noise.scatternet``;
reference ScatternetFilteredNoiseGenerator, py/noise_generation.py:2035-2193,
and ScatternetFilteredNoise, py/noise.py:1596-1662).

A scattering layer is one wavelet level whose oriented highpasses become
smooth magnitudes (``sqrt(x² + b²) − b``), stacked with the lowpass. Two
backends, both the port's exact float32 transforms:

- ``wavelet_backend="dtcwt"`` (default): the dual-tree transform
  (:mod:`..wavelets.dtcwt`), lowpass + 6 oriented magnitudes, ×7 channels
  and spatial ÷2 an order (pytorch_wavelets' ScatLayer);
- ``wavelet_backend="dwt"``: the real DWT (:func:`..wavelets.dwt._afb2d`),
  lowpass + 3 magnitudes, ×4 channels an order.

Channels are band-major, as pytorch_wavelets lays them out: a layer's output
is ``(B, mult, C, H', W') → (B, mult·C, H', W')``, so ``output_offset``
windows (increment C) select one scattering band across all input channels.
``scatternet_order == 2`` is the true second-order layer (ScatLayerj2: ×49,
spatial ÷4; ×16 on the DWT backend); other orders stack |order| first-order
layers. The orchestration (output modes, the ``output_offset`` window, the
per-channel mode, spatial compensation 2^order) is the JAX package's, torch's
no-op ``squeeze(2)`` included.
"""

from __future__ import annotations

import math

import torch

from ..core.normalize import scale_noise
from ..ops.resample import scale_samples
from ..wavelets.coeffs import get_wavelet
from ..wavelets.dtcwt import dtcwt2d
from ..wavelets.dwt import _afb2d
from .base import NoiseCtx, NoiseItem, fix_output_frames
from .generators import Generator


def _band_major(yl: torch.Tensor, mags: torch.Tensor) -> torch.Tensor:
    """Stack lowpass (B, C, H, W) + magnitudes (B, C, K, H, W) band-major:
    (B, 1+K, C, H', W') → (B, (1+K)·C, H', W'), cropped to the common
    spatial size (pytorch_wavelets' ScatLayer layout)."""
    b = yl.shape[0]
    th = min(yl.shape[-2], mags.shape[-2])
    tw = min(yl.shape[-1], mags.shape[-1])
    mags_bm = torch.movedim(mags[..., :th, :tw], 2, 1)  # (B, K, C, H', W')
    stacked = torch.cat([yl[:, None, :, :th, :tw], mags_bm], dim=1)
    return stacked.reshape(b, -1, th, tw)


def _real_mag(bands: torch.Tensor, magbias: float) -> torch.Tensor:
    return torch.sqrt(bands**2 + magbias**2) - magbias


def _complex_mag(z: torch.Tensor, magbias: float) -> torch.Tensor:
    return torch.sqrt(z.real**2 + z.imag**2 + magbias**2) - magbias


def _tree_mean(yls) -> torch.Tensor:
    return (yls[0] + yls[1] + yls[2] + yls[3]) / 4.0


def scat_layer_dwt(x: torch.Tensor, *, wave: str = "db2", mode: str = "symmetric",
                   magbias: float = 1e-2) -> torch.Tensor:
    """One real-DWT scattering layer: (B, C, H, W) → (B, 4C, H', W'),
    band-major [lowpass·C, LH·C, HL·C, HH·C]."""
    yl, bands = _afb2d(x, get_wavelet(wave), mode)
    return _band_major(yl, _real_mag(bands, magbias))


def scat_layer_dtcwt(x: torch.Tensor, *, biort: str = "near_sym_a", qshift: str = "qshift_a",
                     magbias: float = 1e-2) -> torch.Tensor:
    """One dual-tree scattering layer: (B, C, H, W) → (B, 7C, H/2, W/2):
    the trees' mean lowpass + the 6 oriented complex magnitudes."""
    yls, yhs = dtcwt2d(x, level=1, biort=biort, qshift=qshift)
    return _band_major(_tree_mean(yls), _complex_mag(yhs[0], magbias))


def _crop_to(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return a[..., :h, :w]


def _j2_parts(s0, s1_j1_lp, s1_j2, s2, b, c, k):
    """Band-major ``[s0, S1_j1@2 (k), S1_j2 (k), S2 (k²)]`` at the common size."""
    th = min(s0.shape[-2], s1_j2.shape[-2], s1_j1_lp.shape[-2], s2.shape[-2])
    tw = min(s0.shape[-1], s1_j2.shape[-1], s1_j1_lp.shape[-1], s2.shape[-1])
    parts = [
        _crop_to(s0, th, tw).reshape(b, 1, c, th, tw),
        _crop_to(s1_j1_lp, th, tw).reshape(b, k, c, th, tw),
        torch.movedim(_crop_to(s1_j2, th, tw), 2, 1),
        _crop_to(s2, th, tw).reshape(b, k * k, c, th, tw),
    ]
    return torch.cat(parts, dim=1).reshape(b, (1 + k) ** 2 * c, th, tw)


def scat_layer_j2(x: torch.Tensor, *, biort: str = "near_sym_a", qshift: str = "qshift_a",
                  magbias: float = 1e-2) -> torch.Tensor:
    """True second-order dual-tree scattering (ScatLayerj2): (B, C, H, W) →
    (B, 49C, H/4, W/4). Two DTCWT levels give the scale-2 lowpass ``s0`` and
    the magnitudes ``S1_j1`` (6, H/2) and ``S1_j2`` (6, H/4); ``S1_j1`` (a
    6C-channel image, [old band, channel]) goes through one more level-1
    layer, whose lowpass is ``S1_j1`` at scale 2 and whose magnitudes are
    ``S2`` (36, [new band, old band, channel])."""
    b, c = x.shape[:2]
    yls, yhs = dtcwt2d(x, level=2, biort=biort, qshift=qshift)
    s1_j1 = _complex_mag(yhs[0], magbias)  # (B, C, 6, H/2, W/2)
    p = torch.movedim(s1_j1, 2, 1).reshape(b, 6 * c, *s1_j1.shape[-2:])
    yls2, yhs2 = dtcwt2d(p, level=1, biort=biort, qshift=qshift)
    s2 = torch.movedim(_complex_mag(yhs2[0], magbias), 2, 1)  # (B, 6new, 6C, H/4, W/4)
    return _j2_parts(_tree_mean(yls), _tree_mean(yls2), _complex_mag(yhs[1], magbias), s2,
                     b, c, 6)


def scat_layer_j2_dwt(x: torch.Tensor, *, wave: str = "db2", mode: str = "symmetric",
                      magbias: float = 1e-2) -> torch.Tensor:
    """Second-order scattering over the real DWT (the JAX package's
    extension): :func:`scat_layer_j2`'s structure with 3 bands a level →
    (B, 16C, ~H/4, ~W/4)."""
    w = get_wavelet(wave)
    b, c = x.shape[:2]
    yl1, bands1 = _afb2d(x, w, mode)
    s1_j1 = _real_mag(bands1, magbias)  # (B, C, 3, H/2, W/2)
    s0, bands2 = _afb2d(yl1, w, mode)
    p = torch.movedim(s1_j1, 2, 1).reshape(b, 3 * c, *s1_j1.shape[-2:])
    s1_j1_lp, bands2b = _afb2d(p, w, mode)
    s2 = torch.movedim(_real_mag(bands2b, magbias), 2, 1)  # (B, 3new, 3C, ...)
    return _j2_parts(s0, s1_j1_lp, _real_mag(bands2, magbias), s2, b, c, 3)


class ScatternetFilteredGenerator(Generator):
    name = "scatternetfilter"
    MIN_DIMS = 4
    MAX_DIMS = 4

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "mode": "symmetric",
            "magbias": 1e-02,
            "use_symmetric_filter": False,
            "biort": "near_sym_a",
            "qshift": "qshift_a",
            "wave": "db2",
            "wavelet_backend": "dtcwt",
            "output_offset": 0.0,
            "scatternet_order": 1,
            "per_channel_scatternet": False,
            "output_mode": "channels_adjusted",
            "upscale_mode": None,
            "noise_sampler": None,
        }

    def _validate(self):
        if self.output_mode not in {
            "channels", "channels_adjusted", "channels_scaled",
            "flat", "flat_adjusted", "flat_scaled",
        }:
            raise ValueError("Bad output mode")

    def _inner_shape(self, ctx: NoiseCtx):
        """The shape the inner sampler draws at (spatial compensation for
        the adjusted modes, py/noise.py:1614-1633)."""
        comp = 2 ** abs(self.scatternet_order) if (
            self.output_mode.endswith("_adjusted") and self.scatternet_order != 0) else 1
        b, c, h, w = ctx.adjusted_shape()
        return (b, c, h * comp, w * comp)

    def couples(self, ctx):
        """Its output is padded or trimmed on the whole flattened draw, so a
        rank's block takes elements of other rows: on any shard the whole
        latent is drawn."""
        return True

    def init_state(self, ctx, seed):
        self._validate()
        ctx = ctx.whole()  # on a shard, the whole latent's draw (couples)
        if self.noise_sampler is None:
            return ()
        return self.noise_sampler.init_state(ctx.with_shape(self._inner_shape(ctx)), seed)

    def _banks(self):
        """Bank names, honouring use_symmetric_filter as the reference does
        (py/noise_generation.py:2056-2063)."""
        biort = "near_sym_b_bp" if self.use_symmetric_filter else self.biort
        qshift = "qshift_b_bp" if self.use_symmetric_filter else self.qshift
        return biort, qshift

    def _scatter(self, x):
        biort, qshift = self._banks()
        dtcwt = self.wavelet_backend == "dtcwt"
        if self.scatternet_order == 2:
            if dtcwt:
                return scat_layer_j2(x, biort=biort, qshift=qshift, magbias=self.magbias)
            return scat_layer_j2_dwt(x, wave=self.wave, mode=self.mode, magbias=self.magbias)
        for _ in range(max(1, abs(self.scatternet_order))):
            if dtcwt:
                x = scat_layer_dtcwt(x, biort=biort, qshift=qshift, magbias=self.magbias)
            else:
                x = scat_layer_dwt(x, wave=self.wave, mode=self.mode, magbias=self.magbias)
        return x

    def generate(self, ctx, state, seed, sigma, sigma_next):
        if ctx.shard is not None:  # called directly by ScatternetFilteredNoise
            noise, state = self.generate(ctx.whole(), state, seed, sigma, sigma_next)
            return ctx.block(noise, ctx.adjusted_shape()), state
        self._validate()
        adjusted_shape = ctx.adjusted_shape()
        b, c, height, width = adjusted_shape
        scaled = self.output_mode.endswith("_scaled")
        adjusted = scaled or self.output_mode.endswith("_adjusted")
        order = abs(self.scatternet_order)
        order_comp = 2**order
        output_mode = self.output_mode.split("_", 1)[0] if adjusted else self.output_mode
        spatial_comp = 1 if adjusted else order_comp
        if self.noise_sampler is None:
            temp_shape = (
                (b, c, height * spatial_comp, width * spatial_comp)
                if spatial_comp != 1 and not scaled
                else ((b, c, height * order_comp, width * order_comp)
                      if self.output_mode.endswith("_adjusted") and order
                      else adjusted_shape)
            )
            noise = self.randn(ctx, seed, temp_shape)
        else:
            noise, state = self.noise_sampler.sample(
                ctx.with_shape(self._inner_shape(ctx)), state, seed, sigma, sigma_next,
                normalized=False)
        if scaled:
            noise = scale_samples(noise, width * order_comp, height * order_comp,
                                  mode=self.upscale_mode or "bilinear")
        if self.scatternet_order == 0:
            return fix_output_frames(ctx, noise), state
        if self.per_channel_scatternet:
            out = torch.stack([self._scatter(noise[:, ch:ch + 1]) for ch in range(c)], dim=0)
        else:
            out = self._scatter(noise)[None]  # (1, B, mult*C, H', W')
        base_channels = 1 if self.per_channel_scatternet else c
        if output_mode == "flat":
            out = out.reshape(out.shape[0], b, -1)
            initial_size = math.prod(adjusted_shape[(2 if self.per_channel_scatternet else 1):])
        elif adjusted:
            initial_size = base_channels
        else:
            initial_size = base_channels * (order_comp**2)
        increment = 1 if output_mode == "flat" else base_channels
        out_size = out.shape[2]
        offset_size = (out_size - initial_size) / increment
        output_offset = self.output_offset
        if output_offset == 0 or abs(output_offset) >= 1:
            output_offset = int(output_offset)
            if output_offset < 0:
                output_offset = int(offset_size + 1) + output_offset
        else:
            if output_offset < 0:
                output_offset += 1.0
            output_offset = round(offset_size * output_offset)
        base_idx = int(output_offset * increment)
        base_idx = max(0, min(out_size - initial_size, base_idx))
        out = out[:, :, base_idx: base_idx + initial_size]
        if self.per_channel_scatternet:
            # torch's squeeze(dim=2) is a no-op on a non-unit axis (the flat
            # modes keep initial_size there)
            out = torch.movedim(out.squeeze(2), 0, 1)
        else:
            out = out[0]
        if output_mode == "channels":
            out = out[..., :height, :width]
        pad_needed = math.prod(adjusted_shape) - out.numel()
        if pad_needed > 0:
            out = torch.cat([out.reshape(-1), out.new_zeros(pad_needed)])
        elif pad_needed < 0:
            out = out.reshape(-1)[: math.prod(adjusted_shape)]
        return out.reshape(adjusted_shape), state


class ScatternetFilteredNoise(NoiseItem):
    """The combinator over :class:`ScatternetFilteredGenerator` with an
    inner noise item (py/noise.py:1596-1662)."""

    MIN_DIMS = 4
    MAX_DIMS = 4
    SHARDABLE = True  # the whole draw's block (ScatternetFilteredGenerator.couples)

    def __init__(self, factor=1.0, *, noise=None, normalize=None, normalize_noise=False,
                 padding_mode="symmetric", **gen_kwargs):
        super().__init__(factor, normalize=normalize, noise=noise, normalize_noise=normalize_noise,
                         padding_mode=padding_mode, gen_kwargs=dict(gen_kwargs))
        self._gen = ScatternetFilteredGenerator(1.0, noise_sampler=noise, mode=padding_mode,
                                                **gen_kwargs)

    def clone(self):
        p = self.cloned_params()
        factor = p.pop("factor")
        kw = p.pop("gen_kwargs")
        return self.__class__(factor, **p, **kw)

    def check_dims(self, ctx):
        self._gen.check_dims(ctx)

    def init_state(self, ctx, seed):
        return self._gen.init_state(ctx, seed)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.normalize if self.normalize is not None else normalized
        noise, state = self._gen.generate(ctx, state, seed, sigma, sigma_next)
        return scale_noise(noise, self.factor, normalized=bool(normalize),
                           shard=ctx.shard), state


__all__ = ["ScatternetFilteredGenerator", "ScatternetFilteredNoise", "scat_layer_dtcwt",
           "scat_layer_dwt", "scat_layer_j2", "scat_layer_j2_dwt"]
