"""Wavelet filter banks computed from first principles (no pywt dependency).

Daubechies filters come from spectral factorization of the halfband
polynomial (Strang & Nguyen construction); symlets use the same root set but
pick the reciprocal-root subset minimizing phase nonlinearity (brute-force
over the ≤2^(p-1) subsets — exact, not a table). Biorthogonal spline
filters (LeGall 5/3 = bior2.2, CDF 9/7) are derived from Cohen-Daubechies-
Feauveau factorizations. Everything is float64 NumPy; perfect reconstruction
is asserted by the test suite rather than trusted from a table.

Replaces the pywt/pytorch_wavelets dependency of the reference
(py/wavelet_functions.py:12-21). A copy of ``sonar_tpu.wavelets.coeffs``
(numpy only): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class WaveletFilters:
    name: str
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray

    @property
    def filt_len(self) -> int:
        return len(self.dec_lo)


def _orthogonal_bank(name: str, h: np.ndarray) -> WaveletFilters:
    """Build the 4-filter bank from an orthogonal scaling filter ``h``
    (sum = sqrt(2)). pywt conventions: dec filters are time-reversed."""
    h = np.asarray(h, np.float64)
    g = h[::-1].copy()
    g[1::2] *= -1  # g[n] = (-1)^n h[L-1-n]
    return WaveletFilters(
        name=name,
        dec_lo=h[::-1].copy(),
        dec_hi=g[::-1].copy(),
        rec_lo=h.copy(),
        rec_hi=g.copy(),
    )


def _halfband_roots(p: int) -> tuple[np.ndarray, np.ndarray]:
    """Roots of the Daubechies halfband factor B(z) with z^(p-1) cleared.

    P(y) = Σ_{k<p} C(p-1+k, k) y^k evaluated at y = (2 - z - 1/z)/4,
    multiplied by z^(p-1): a degree-2(p-1) polynomial whose roots come in
    (r, 1/r) reciprocal pairs (complex ones additionally in conjugate pairs).
    """
    # coefficients of P(y), ascending
    Py = np.array([math.comb(p - 1 + k, k) for k in range(p)], np.float64)
    # y = (2 - z - z^-1)/4 → y*z = (2z - z^2 - 1)/4. Build B(z) = z^(p-1) P(y).
    # Use polynomial composition: represent y*z as quadratic q(z) = (-z^2+2z-1)/4
    # then z^(p-1) P(y) = Σ_k Py[k] * q(z)^k * z^(p-1-k).
    q = np.array([-0.25, 0.5, -0.25])  # descending: -z²/4 + z/2 - 1/4
    B = np.zeros(2 * p - 1)
    for k in range(p):
        term = np.array([1.0])
        for _ in range(k):
            term = np.convolve(term, q)
        # multiply by z^(p-1-k): shift (append zeros)
        term = np.concatenate([term, np.zeros(p - 1 - k)])
        B[len(B) - len(term):] += Py[k] * term
    roots = np.roots(B)
    inside = roots[np.abs(roots) < 1.0 - 1e-12]
    return roots, inside


def _scaling_from_roots(p: int, chosen: np.ndarray) -> np.ndarray:
    """h(z) ∝ (1+z)^p Π(z - r) normalized to Σh = √2, ‖h‖ = 1."""
    poly = np.array([1.0 + 0j])
    for _ in range(p):
        poly = np.convolve(poly, np.array([1.0, 1.0]))
    for r in chosen:
        poly = np.convolve(poly, np.array([1.0, -r]))
    h = np.real(poly)
    h *= math.sqrt(2.0) / h.sum()
    return h


@functools.lru_cache(maxsize=None)
def daubechies(p: int) -> np.ndarray:
    """db{p} scaling filter, length 2p (minimum-phase factorization)."""
    if p < 1:
        raise ValueError("daubechies order must be >= 1")
    if p == 1:
        return np.array([1.0, 1.0]) / math.sqrt(2.0)
    _, inside = _halfband_roots(p)
    return _scaling_from_roots(p, inside)


@functools.lru_cache(maxsize=None)
def symlet(p: int) -> np.ndarray:
    """sym{p}: same halfband roots as db{p}, reciprocal-pair subset chosen
    to minimize phase nonlinearity (the standard "least asymmetric" pick)."""
    if p < 2:
        return daubechies(max(p, 1))
    roots, _ = _halfband_roots(p)
    # group into reciprocal pairs/quadruples; from each group pick either the
    # inside or outside representatives
    used = np.zeros(len(roots), bool)
    groups = []
    for i, r in enumerate(roots):
        if used[i]:
            continue
        used[i] = True
        group_in = [r] if abs(r) < 1 else []
        group_out = [r] if abs(r) >= 1 else []
        # find reciprocal (and conjugates)
        for j in range(i + 1, len(roots)):
            if used[j]:
                continue
            s = roots[j]
            if (
                abs(s - 1.0 / np.conj(r)) < 1e-7
                or abs(s - 1.0 / r) < 1e-7
                or abs(s - np.conj(r)) < 1e-7
            ):
                used[j] = True
                (group_in if abs(s) < 1 else group_out).append(s)
        groups.append((group_in, group_out))

    def phase_nonlinearity(h: np.ndarray) -> float:
        # deviation of the phase from linear, sampled on (0, pi)
        w = np.linspace(0.05, math.pi - 0.05, 128)
        H = np.polyval(h[::-1], np.exp(-1j * w))
        ph = np.unwrap(np.angle(H))
        slope = np.polyfit(w, ph, 1)
        return float(np.sum((ph - np.polyval(slope, w)) ** 2))

    best, best_err = None, np.inf
    n_choice = len(groups)
    for bits in range(1 << n_choice):
        chosen = []
        ok = True
        for gi, (gin, gout) in enumerate(groups):
            grp = gin if not (bits >> gi) & 1 else gout
            if not grp:
                ok = False
                break
            chosen.extend(grp)
        if not ok or len(chosen) != p - 1:
            continue
        h = _scaling_from_roots(p, np.asarray(chosen))
        if not np.all(np.isfinite(h)):
            continue
        err = phase_nonlinearity(h)
        if err < best_err:
            best, best_err = h, err
    if best is None:  # numerical fallback
        return daubechies(p)
    return best


def _spline_lowpass(n: int) -> np.ndarray:
    """B-spline lowpass: ((1+z)/2)^n · √2, centered."""
    poly = np.array([1.0])
    for _ in range(n):
        poly = np.convolve(poly, [0.5, 0.5])
    return poly * math.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def biorthogonal(nr: int, nd: int) -> tuple[np.ndarray, np.ndarray]:
    """CDF biorthogonal spline pair (rec_lo, dec_lo) for bior{nr}.{nd}.

    rec_lo is the B-spline of order nr; dec_lo comes from dividing the
    Lagrange halfband P(z) of order (nr+nd)/2 by the spline factor.
    """
    if (nr + nd) % 2:
        raise ValueError("bior orders must have even sum")
    p = (nr + nd) // 2
    # full halfband: (1+z)^(2p)/2^(2p) * P(y) expanded; build via roots
    Py = np.array([math.comb(p - 1 + k, k) for k in range(p)], np.float64)
    q = np.array([-0.25, 0.5, -0.25])
    B = np.zeros(2 * p - 1)
    for k in range(p):
        term = np.array([1.0])
        for _ in range(k):
            term = np.convolve(term, q)
        term = np.concatenate([term, np.zeros(p - 1 - k)])
        B[len(B) - len(term):] += Py[k] * term
    ones = np.array([1.0])
    for _ in range(2 * p):
        ones = np.convolve(ones, [0.5, 0.5])
    halfband = np.convolve(ones, B) * 2.0  # halfband product filter
    rec_lo = _spline_lowpass(nr)
    # dec_lo = halfband / rec_lo (polynomial deconvolution)
    dec_lo, rem = np.polydiv(halfband, rec_lo / math.sqrt(2.0))
    if np.max(np.abs(rem)) > 1e-8:
        raise ValueError("bior factorization failed")
    dec_lo = dec_lo / math.sqrt(2.0) * 2.0
    # normalize both to sum sqrt(2)
    rec_lo = rec_lo * (math.sqrt(2.0) / rec_lo.sum())
    dec_lo = dec_lo * (math.sqrt(2.0) / dec_lo.sum())
    return rec_lo, dec_lo


def _np_afb_per(x: np.ndarray, dec: np.ndarray) -> np.ndarray:
    """NumPy mirror of the periodization analysis branch: a[i] =
    (x ⊛ dec)[2i+1] circularly, i < n/2."""
    n = len(x)
    idx = (np.arange(n)[:, None] - np.arange(len(dec))[None, :]) % n
    full = (x[idx] * dec[None, :]).sum(-1)
    return full[1::2][: n // 2]


def _np_pr_error(dl, dh, rl, rh, n: int = 16) -> float:
    """Round-trip error of one AFB/SFB level under periodization, using the
    same sample alignment as the DWT (numpy)."""
    rng = np.random.default_rng(12345)
    x = rng.standard_normal(n)
    lo = _np_afb_per(x, dl)
    hi = _np_afb_per(x, dh)
    m = len(lo)
    L = len(rl)
    # circular synthesis identical to the DWT's: extend coefficients by p
    # on both sides, full linear synthesis, crop [L-2+2p : +n]
    p = max(1, (L + 1) // 2)
    lo_e = np.concatenate([lo[-p:], lo, lo[:p]])
    hi_e = np.concatenate([hi[-p:], hi, hi[:p]])
    up_lo = np.zeros(2 * len(lo_e) - 1)
    up_lo[::2] = lo_e
    up_hi = np.zeros(2 * len(hi_e) - 1)
    up_hi[::2] = hi_e
    z = np.convolve(up_lo, rl) + np.convolve(up_hi, rh)
    start = (L - 2 + 2 * p) if L > 2 else 2 * p
    rec = z[start : start + n]
    if len(rec) < n:
        return np.inf
    return float(np.abs(rec - x).max())


def _bior_bank(name: str, nr: int, nd: int) -> WaveletFilters:
    """Assemble the 4-filter bior bank; the hi-filter sign/alignment
    convention is found by a direct numpy perfect-reconstruction search over
    the small candidate space, so every order is correct by construction."""
    rec_lo, dec_lo = biorthogonal(nr, nd)
    L = max(len(rec_lo), len(dec_lo))
    L += L % 2

    def pad(f, off):
        return np.concatenate([np.zeros(off), f, np.zeros(L - len(f) - off)])

    import itertools

    best = None
    for off_d in range(L - len(dec_lo) + 1):
        for off_r in range(L - len(rec_lo) + 1):
            dl, rl = pad(dec_lo, off_d), pad(rec_lo, off_r)
            for par_dh, par_rh in itertools.product((0, 1), (0, 1)):
                dh = rl.copy()
                dh[par_dh::2] *= -1
                rh = dl.copy()
                rh[par_rh::2] *= -1
                err = _np_pr_error(dl, dh, rl, rh)
                if err < 1e-9 and best is None:
                    best = (dl, dh, rl, rh)
    if best is None:
        raise ValueError(f"No PR convention found for {name}")
    dl, dh, rl, rh = best
    return WaveletFilters(name, dl, dh, rl, rh)


@functools.lru_cache(maxsize=None)
def get_wavelet(name: str) -> WaveletFilters:
    """Look up a filter bank by pywt-style name: haar, db1-db16, sym2-sym10,
    bior2.2 / bior4.4 / bior3.1, ..."""
    name = name.lower().strip()
    if name == "haar":
        return _orthogonal_bank("haar", daubechies(1))
    if name.startswith("db"):
        p = int(name[2:])
        if not 1 <= p <= 16:
            raise ValueError("db order must be 1..16")
        return _orthogonal_bank(name, daubechies(p))
    if name.startswith("sym"):
        p = int(name[3:])
        if not 2 <= p <= 10:
            raise ValueError("sym order must be 2..10")
        return _orthogonal_bank(name, symlet(p))
    if name.startswith("bior"):
        nr, nd = name[4:].split(".")
        return _bior_bank(name, int(nr), int(nd))
    raise ValueError(f"Unknown wavelet {name!r}")


def wavelist() -> tuple[str, ...]:
    return (
        "haar",
        *(f"db{i}" for i in range(1, 17)),
        *(f"sym{i}" for i in range(2, 11)),
        "bior2.2",
        "bior2.6",
        "bior3.1",
        "bior4.4",
    )
