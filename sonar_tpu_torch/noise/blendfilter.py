"""BlendFilterNoise and its frequency filter and enhancements (port of
``sonar_tpu.noise.blendfilter``; reference py/noise.py:1701-1774 and
py/nodes/integrations.py:20-100).

- ``ffilter(t, threshold, scale, filt, strength)`` — a radial gain curve
  (a preset name or a list) on ``torch.fft.rfft2(norm="ortho")``, the band
  below ``threshold`` scaled by ``scale``, lerped by ``strength``. The gain
  is made on the host in float64, as the JAX package makes it, and kept on
  the device once per (size, curve, device).
- ``enhance_tensor(t, name, scale)`` — blur and sharpen (a separable
  gaussian with reflected edges), contrast and saturation.

The blur's taps meet their windows in a product and a sum, as the port's
DWT does, never a matmul or a convolution: exact float32 whatever the TF32
switches say (the JAX package's ``windows @ k`` is a float32 dot there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..core.normalize import scale_noise
from ..core.rng import derive_seed
from .combinators import MultiChildNoise

# named gain curves over the normalized radial frequency r in [0, 1]
FILTER_PRESETS: dict[str, tuple[float, ...]] = {
    "none": (1.0,),
    "bandpass": (0.0, 0.5, 1.0, 1.0, 0.5, 0.0),
    "lowpass": (1.0, 1.0, 0.75, 0.4, 0.15, 0.0),
    "highpass": (0.0, 0.15, 0.4, 0.75, 1.0, 1.0),
    "passthrough": (1.0,),
    "gaussianblur": (1.0, 0.8, 0.5, 0.25, 0.1, 0.03),
    "edge": (0.0, 0.2, 0.5, 0.8, 1.0, 1.2),
    "sharpen": (1.0, 1.0, 1.1, 1.25, 1.4, 1.6),
}

# device constants, made once: (kind, ..., device, dtype) -> tensor
_CONSTANTS: dict = {}


def _radius(h: int, w: int) -> np.ndarray:
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    return np.sqrt(fy**2 + fx**2) / math.sqrt(0.5)  # normalized to [0, 1]


def _radial_gain(gains, h: int, w: int) -> np.ndarray:
    """Interpolate a gain list over the rfft2 radial frequency grid."""
    gains = np.asarray(gains, np.float64)
    xs = np.linspace(0.0, 1.0, len(gains)) if len(gains) > 1 else np.array([0.0, 1.0])
    ys = gains if len(gains) > 1 else np.repeat(gains, 2)
    return np.interp(np.clip(_radius(h, w), 0, 1), xs, ys)


def _gain(gains: tuple, h: int, w: int, threshold: float, scale: float, device) -> torch.Tensor:
    key = ("gain", gains, h, w, threshold, scale, str(device))
    g = _CONSTANTS.get(key)
    if g is None:
        gain = _radial_gain(gains, h, w)
        gain = np.where(_radius(h, w) < threshold, gain * scale, gain)
        g = _CONSTANTS[key] = torch.from_numpy(gain.astype(np.float32)).to(device)
    return g


def ffilter(t: torch.Tensor, threshold: float, scale: float, filt, strength: float
            ) -> torch.Tensor:
    """Frequency filter: the gain curve on the rfft, the stop band below the
    radial ``threshold`` scaled by ``scale``, the result lerped by
    ``strength``. Computed in float32, rounded once to ``t``'s type."""
    if isinstance(filt, str):
        gains = FILTER_PRESETS.get(filt)
        if gains is None:
            raise ValueError(
                f"Unknown ffilter {filt!r}; valid: {', '.join(sorted(FILTER_PRESETS))}")
    else:
        gains = tuple(float(v) for v in filt)
    h, w = t.shape[-2], t.shape[-1]
    gain = _gain(gains, h, w, float(threshold), float(scale), t.device)
    spec = torch.fft.rfft2(t.to(torch.float32), norm="ortho")
    out = torch.fft.irfft2(spec * gain, s=(h, w), norm="ortho").to(t.dtype)
    if strength == 1.0:
        return out
    return t + (out - t) * strength


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2 * sigma**2))
    return k / k.sum()


def _reflect_index(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each sample of a length-``n`` axis padded by
    ``radius`` on both sides in ``jnp.pad``'s "reflect" mode (edges not
    repeated; wider pads reflect again)."""
    key = ("reflect", n, radius, str(device))
    idx = _CONSTANTS.get(key)
    if idx is None:
        i = np.arange(-radius, n + radius)
        if n > 1:
            i = np.abs(i) % (2 * n - 2)
            i = np.where(i >= n, 2 * n - 2 - i, i)
        else:
            i = np.zeros_like(i)
        idx = _CONSTANTS[key] = torch.from_numpy(i).to(device)
    return idx


def _sep_blur(t: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable reflect-padded gaussian blur over the last two axes: along
    each axis a gather that pads, an ``unfold`` of the windows and a
    product-sum with the taps."""
    radius = max(1, int(3 * sigma))
    key = ("taps", sigma, radius, str(t.device), t.dtype)
    k = _CONSTANTS.get(key)
    if k is None:
        k = _CONSTANTS[key] = torch.from_numpy(_gaussian_kernel(sigma, radius)).to(
            device=t.device, dtype=t.dtype)

    def conv_axis(x, axis):
        moved = torch.movedim(x, axis, -1)
        padded = moved.index_select(-1, _reflect_index(moved.shape[-1], radius, x.device))
        windows = padded.unfold(-1, 2 * radius + 1, 1)
        return torch.movedim((windows * k).sum(-1), -1, axis)

    return conv_axis(conv_axis(t, -2), -1)


def enhance_tensor(t: torch.Tensor, name: str, scale: float = 1.0, *, sigma=None,
                   **_kw) -> torch.Tensor:
    """The enhancement table (in place of bleh's enhance_tensor)."""
    name = name.lower()
    if name in ("none", ""):
        return t
    handler = ENHANCE_HANDLERS.get(name)
    if handler is None:
        valid = ", ".join(sorted(ENHANCE_HANDLERS))
        raise ValueError(f"Unknown enhance mode {name!r}; valid: {valid}")
    return handler(t, scale, sigma=sigma)


def _enh_blur(t, scale, **_kw):
    return t + (_sep_blur(t) - t) * scale


def _enh_sharpen(t, scale, **_kw):
    return t + (t - _sep_blur(t)) * scale


def _enh_contrast(t, scale, **_kw):
    mean = t.mean(dim=(-2, -1), keepdim=True)
    return mean + (t - mean) * (1.0 + scale)


def _enh_saturate(t, scale, **_kw):
    mean = t.mean(dim=-3, keepdim=True)
    return mean + (t - mean) * (1.0 + scale)


ENHANCE_HANDLERS = {
    "blur": _enh_blur,
    "gaussianblur": _enh_blur,
    "sharpen": _enh_sharpen,
    "unsharp": _enh_sharpen,
    "contrast": _enh_contrast,
    "saturate": _enh_saturate,
}


class BlendFilterNoise(MultiChildNoise):
    """Blends or adds its children's noise (``simple_add`` is the
    factor-weighted sum), with ``ffilter`` and an enhancement on each
    child's noise, on the result, or both (py/noise.py:1701-1774)."""

    def __init__(self, factor=1.0, *, noise, blend_mode="simple_add",
                 ffilter=None, ffilter_scale=1.0, ffilter_strength=0.5,
                 ffilter_threshold=1, enhance_mode="none", enhance_strength=0.25,
                 affect="result", normalize_noise=None, normalize_result=None):
        super().__init__(factor, items=noise, blend_mode=blend_mode,
                         ffilter=ffilter, ffilter_scale=ffilter_scale,
                         ffilter_strength=ffilter_strength,
                         ffilter_threshold=ffilter_threshold,
                         enhance_mode=enhance_mode,
                         enhance_strength=enhance_strength, affect=affect,
                         normalize_noise=normalize_noise,
                         normalize_result=normalize_result)

    def apply_effects(self, noise, sigma):
        if self.ffilter:
            noise = ffilter(noise, self.ffilter_threshold, self.ffilter_scale,
                            self.ffilter, self.ffilter_strength)
        if self.enhance_mode != "none" and self.enhance_strength != 0:
            noise = enhance_tensor(noise, self.enhance_mode, self.enhance_strength,
                                   sigma=sigma)
        return noise

    def _effects(self, ctx, noise, sigma):
        # "saturate" takes the mean over dimension -3: the whole latent's
        # where that dimension is split (a 5-D latent's frames)
        return ctx.across((-3,), lambda n: self.apply_effects(n, sigma), noise)

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        n = len(self.items)
        normalize_noise = self.get_normalize("normalize_noise", normalized or n > 1)
        normalize_result = self.get_normalize("normalize_result", normalized)
        noise_effects = self.affect in {"noise", "both"}
        result_effects = self.affect in {"result", "both"}
        total, new_states = None, []
        for i, item in enumerate(self.items):
            cur, st = item.sample(ctx, state[i], derive_seed(seed, i), sigma, sigma_next,
                                  normalized=False)
            new_states.append(st)
            cur = scale_noise(cur, normalized=bool(normalize_noise), shard=ctx.shard)
            if noise_effects:
                cur = self._effects(ctx, cur, sigma)
            if self.blend_mode == "simple_add":
                cur = cur * item.factor
                total = cur if total is None else total + cur
            else:
                total = BLENDING_MODES[self.blend_mode](
                    torch.zeros_like(cur) if total is None else total, cur, item.factor)
        total = scale_noise(total, self.factor, normalized=bool(normalize_result),
                            shard=ctx.shard)
        if result_effects:
            total = self._effects(ctx, total, sigma)
        return total, tuple(new_states)
