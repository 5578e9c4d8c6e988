"""``sonar_euler_ancestral``: the momentum Euler-ancestral sampler in its
default mode (NEW momentum, history from zero, lerp blends, history updated
every step), py/sonar.py:70-320 and :529-623.

Each step: the history takes ``denoised/σ``, the derivative
``d = (x − denoised)/σ`` is mixed with it by ``momentum``, the history
takes ``d``, and ``x ← x + mixed·(σ_down − σ) + noise·s_noise·σ_up`` (no
noise where the next sigma is 0; the draw is still made, so the stream
stays in step)."""

from __future__ import annotations

from ..sampling import ancestral_split


def _lerp(a, b, t):
    return a + (b - a) * t


def sample(denoise, x, sigmas, *, noise, momentum: float = 0.95, momentum_hist: float = 0.75,
           direction: float = 1.0, eta: float = 1.0, s_noise: float = 1.0):
    hd_ratio = momentum_hist
    hd_scale = 1.0 + abs(direction) * (1.0 - momentum_hist) if direction < 0 else 2.0 - direction
    md_scale = direction
    hd, has = None, False
    sig = [float(s) for s in sigmas]
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, sigma)
        dn = denoised / sigma
        hd = _lerp(dn * md_scale, hd * hd_scale, hd_ratio) if has else dn
        has = True
        d = (x - denoised) / sigma
        mixed = _lerp(hd, d, momentum)
        hd = _lerp(d * md_scale, hd * hd_scale, hd_ratio)
        down, up = ancestral_split(sigma, sigma_next, eta)
        x = x + mixed * (down - sigma)
        draw = noise(i, sigma, sigma_next)
        if sigma_next > 0:
            x = x + draw * (s_noise * up)
    return x
