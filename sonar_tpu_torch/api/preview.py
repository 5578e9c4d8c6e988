"""Array-based inspection tooling (port of ``sonar_tpu.api.preview``):
PIL/ComfyUI-free replacements for the reference's preview pipelines
(py/nodes/powernoise.py:33-53, 217-294, 410-554; SURVEY §5.5). Each returns
a numpy ``uint8`` image.

The filter panels are computed on the host, where the filter's gain surface
is built; the noise panel is drawn on ``device`` (the card unless the
caller says otherwise) and copied back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..noise.power import PowerFilter, PowerNoiseItem, rfft2_to_fft2


def preview_power_filter(pfilter: PowerFilter, *, size=(128, 128), mix: float = 1.0,
                         normalization_factor: float = 1.0,
                         kernel_gain: float = 1 / 3,
                         filter_gain: float = 1 / 3) -> np.ndarray:
    """Render (H, 2W) uint8: the filter's Fourier gain surface next to its
    spatial kernel (PowerFilter.preview, powernoise.py:217-266)."""
    shape = (1, 1, *size)
    filt = PowerFilter.normalize(pfilter.build(size), shape, mix=mix,
                                 normalization_factor=normalization_factor)
    filt_rfft = torch.as_tensor(np.asarray(filt, np.float32))[None, None].to(torch.complex64)
    filter_fft = rfft2_to_fft2(filt_rfft).real
    kernel = torch.fft.irfft2(filt_rfft, s=tuple(size), norm="ortho")
    kernel = torch.roll(kernel, (size[0] // 2, size[1] // 2), dims=(-2, -1))
    img_f = torch.tanh(filter_fft * filter_gain) * 256.0
    img_k = (torch.tanh(kernel * kernel_gain) + 1.0) * 128.0
    img = torch.cat([img_f, img_k], dim=-1)
    return torch.clamp(img, 0, 255).to(torch.uint8)[0, 0].numpy()


def preview_power_noise(item: PowerNoiseItem, *, size=(128, 128),
                        seed: int = 0, device=None) -> np.ndarray:
    """Filter surface + kernel + one noise draw, side by side
    (PowerNoiseItem.preview, powernoise.py:410-454)."""
    from ..noise.base import make_noise_sampler

    base = preview_power_filter(item.power_filter, size=size,
                                mix=item.mix,
                                normalization_factor=item.filter_norm_factor)
    fn, state = make_noise_sampler(item, (1, 1, *size), device=device, seed=seed,
                                   sigma_min=0.01, sigma_max=14.6)
    noise, _ = fn(state, 14.0, 10.0)
    img_n = torch.clamp((torch.tanh(noise * (1 / 3)) + 1.0) * 128.0, 0, 255)
    return np.concatenate([base, img_n.to(torch.uint8)[0, 0].cpu().numpy()], axis=-1)


def noise_to_rgb(noise, *, gain: float = 1 / 3) -> np.ndarray:
    """Any (B, C, H, W) noise → (H, W, 3) uint8 for quick inspection
    (SonarNoiseImage's spirit without the image pipeline); computed where
    the tensor lies."""
    x = torch.as_tensor(noise)[0]
    c = x.shape[0]
    if c >= 3:
        rgb = x[:3]
    else:
        rgb = x[:1].expand((3,) + tuple(x.shape[1:]))
    img = (torch.tanh(rgb * gain) + 1.0) * 127.5
    return torch.clamp(img, 0, 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
