"""``gaussian``: each step's draw is the Philox normals of that draw's seed,
normalized by ``scale_noise`` (the noise item's one normalization; the
generator's own is off)."""

from __future__ import annotations

from .. import philox
from ..sampling import draw_seed, scale_noise


def sampler(seed: int, shape, device):
    def noise(step, sigma, sigma_next):
        return scale_noise(philox.randn(draw_seed(seed, step), shape, device=device))

    return noise
