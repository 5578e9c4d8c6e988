"""``sonar_euler_ancestral``: the momentum Euler-ancestral sampler in its
default mode (NEW momentum, history from zero, lerp blends, history updated
every step), py/sonar.py:70-320 and :529-623.

Each step: the history takes ``denoised/σ``, the derivative
``d = (x − denoised)/σ`` is mixed with it by ``momentum``, the history
takes ``d``, and ``x ← x + mixed·(σ_down − σ) + noise·s_noise·σ_up`` (no
noise where the next sigma is 0; the draw is still made, so the stream
stays in step). With ``ancestral_mode="rf"`` (a flow model, as
``SonarPipeline`` sets it) the step takes the rectified-flow split:
``x ← α·(x + mixed·(σ_down − σ)) + noise·s_noise·σ_up``."""

from __future__ import annotations

from ..sampling import ancestral_split, ancestral_split_rf


def _lerp(a, b, t):
    return a + (b - a) * t


def sample(denoise, x, sigmas, *, noise, momentum: float = 0.95, momentum_hist: float = 0.75,
           direction: float = 1.0, eta: float = 1.0, s_noise: float = 1.0,
           ancestral_mode: str = "vp"):
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
        if ancestral_mode == "rf":
            down, up, alpha = ancestral_split_rf(sigma, sigma_next, eta)
        else:
            (down, up), alpha = ancestral_split(sigma, sigma_next, eta), 1.0
        x = x + mixed * (down - sigma)
        draw = noise(i, sigma, sigma_next)
        if sigma_next > 0:
            x = x * alpha + draw * (s_noise * up)
    return x
