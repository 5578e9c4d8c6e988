"""Published DTCWT filter banks (a copy of ``sonar_tpu.wavelets.kingsbury``,
numpy only: the port imports nothing of the JAX package).

The reference selects named banks through pytorch_wavelets
(py/wavelet_functions.py:62-101): biort
``antonini``/``legall``/``near_sym_a``/``near_sym_b``, qshift
``qshift_06``/``qshift_a``-``qshift_d``. This module ships the published
coefficient tables where they are public and *mathematically verifiable*,
and documents the substitutions where they are not:

EXACT (verified by hard checksums in tests/test_kingsbury.py; the copy is held
equal to the JAX package's in float64 by tests/test_torch_dtcwt.py):

- ``legall``    — CDF 5/3, exact rationals (-1,2,6,2,-1)/8 · (1,2,1)/4.
- ``near_sym_a``— Kingsbury's (5,7)-tap near-symmetric pair. h0o is the
  published (-1,5,12,5,-1)/20; g0o is *uniquely determined* from it by
  perfect reconstruction + 2 vanishing moments (solved here in exact
  arithmetic → (-3/280, -3/56, 73/280, 17/28, ...) = the published
  -0.0107143/-0.0535714/0.2607143/0.6071429 decimals).
- ``antonini``  — CDF 9/7, derived in closed form by spectral
  factorization of the degree-3 maxflat halfband (the real y-root goes to
  the 7-tap synthesis, the complex pair to the 9-tap analysis). This IS
  the published table to float64 accuracy; no copying involved.
- ``qshift_06`` — Kingsbury's published 10-tap (6 nonzero) Q-shift filter
  (Kingsbury 2001); passes Σh=√2 and shift-orthogonality to the 8-decimal
  precision of the published table.
- ``qshift_b``  — the published 14-tap Q-shift filter (same checks).
- ``near_sym_b``— Kingsbury's (13,19)-tap pair, derived EXACTLY
  by Tay-Kingsbury transformation of variables on
  the near_sym_a prototype (tools/derive_nearsym_b.py): the published
  h0o decimals are the rationals (-9,0,114,-240,-247,1520,2844,…)/5120,
  the unique M(z) substitution reproducing them forces the published
  19-tap g0o, and PR transfers from the prototype structurally.

SUBSTITUTED (documented; the toolbox values are unpublished/unavailable):

- ``qshift_a``  → qshift_06 (the toolbox's qshift_a is an *unpublished*
  10,10-nonzero-tap variant; qshift_06 is the published 10-tap filter of
  the same family and length).
- ``qshift_c``/``qshift_d`` → qshift_b (published 14-tap; the 16/18-tap
  tables are not reproducible without the toolbox data files).
- ``near_sym_a_bp``/``near_sym_b_bp`` → their base banks (the bandpass
  45°-subband modification of the rotationally-symmetric transform is
  out of scope; the scaling/wavelet pair is the base bank's).
- ``native``    — the in-repo designed (13,17) banks
  (tools/design_nearsym.py, the pre-round-3 defaults).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

from .coeffs import WaveletFilters, _orthogonal_bank

__all__ = ["biort_pair", "biort_level1_bank", "qshift_scaling",
           "qshift_tree_banks", "BIORT_EXACT", "QSHIFT_EXACT"]


# ---------------------------------------------------------------------------
# exact biorthogonal (level-1) pairs
# ---------------------------------------------------------------------------

_LEGALL_H0 = np.array([-1, 2, 6, 2, -1], np.float64) / 8.0
_LEGALL_G0 = np.array([1, 2, 1], np.float64) / 4.0

_NEAR_SYM_A_H0 = np.array([-1, 5, 12, 5, -1], np.float64) / 20.0
_NEAR_SYM_A_G0 = np.array(
    [Fraction(-3, 280), Fraction(-3, 56), Fraction(73, 280), Fraction(17, 28),
     Fraction(73, 280), Fraction(-3, 56), Fraction(-3, 280)], np.float64)

# Kingsbury's (13,19)-tap near-symmetric pair, EXACT (derivation:
# tools/derive_nearsym_b.py). The pair is the near_sym_a
# prototype pushed through Tay-Kingsbury transformation of variables —
# substituting M(z) = (-3z^3 + 19z + 19/z - 3/z^3)/16 for x = z + 1/z in
# Q(x) = (-x^2+5x+14)/20 and R(x) = (-3x^3-15x^2+82x+200)/280 — which
# both (a) reproduces the published decimal tables exactly
# (0.55943090, 0.29975763, -0.05168806, -0.05564314, 0.02385603,
# 0.00715681, -0.00188337, -0.00134190, 0.00007063) and (b) transfers
# perfect reconstruction from the (5,7) prototype because M(z)+M(-z)=0
# preserves the halfband property (asserted in tests/test_kingsbury.py).
_NEAR_SYM_B_H0 = np.array(
    [-9, 0, 114, -240, -247, 1520, 2844, 1520, -247, -240, 114, 0, -9],
    np.float64) / 5120.0
_NEAR_SYM_B_G0 = np.array(
    [81, 0, -1539, -2160, 8208, 27360, -63816, -59280, 343786, 641600,
     343786, -59280, -63816, 27360, 8208, -2160, -1539, 0, 81],
    np.float64) / 1146880.0


@functools.lru_cache(maxsize=None)
def _antonini_pair() -> tuple[np.ndarray, np.ndarray]:
    """CDF 9/7 by closed-form spectral factorization.

    P(y) = Σ_{k<4} C(3+k,k) y^k with y=(2-z-1/z)/4 is the maxflat
    halfband remainder. Its one real root builds the 7-tap synthesis
    (z-quadratic, reciprocal real pair); the complex-conjugate root pair
    builds the 9-tap analysis (z-quartic). Both keep 4 zeros at z=-1
    split 2+2... in the CDF 9/7 convention analysis and synthesis carry
    (4, 4) zeros at -1 via the (1+z)^4 factors distributed as below."""
    Py = np.array([1.0, 4.0, 10.0, 20.0])  # ascending in y
    roots = np.roots(Py[::-1])
    real = [r for r in roots if abs(r.imag) < 1e-12]
    cplx = [r for r in roots if r.imag > 1e-12]
    assert len(real) == 1 and len(cplx) == 1
    y1 = real[0].real
    y2 = cplx[0]

    def y_to_zpoly(y):
        # y = (2 - z - 1/z)/4  →  z² - (2 - 4y) z + 1 = 0 (monic, z-domain)
        return np.array([1.0 + 0j, -(2.0 - 4.0 * y), 1.0 + 0j])

    # synthesis: (1+z)^4 / 16? — build, then normalize DC gain below
    spline2 = np.array([1.0, 2.0, 1.0])  # (1+z)^2
    g0 = np.convolve(np.convolve(spline2, spline2), y_to_zpoly(y1)).real
    # analysis: (1+z)^4 × z-quartic from the complex pair (y2, conj y2)
    quart = np.convolve(y_to_zpoly(y2), y_to_zpoly(np.conj(y2))).real
    h0 = np.convolve(np.convolve(spline2, spline2), quart)
    # joint normalization: each to DC gain 1 then fix the product to the
    # halfband scale (P(1) = 2 in the sum-1 convention)
    h0 = h0 / h0.sum()
    g0 = g0 / g0.sum()
    return h0, g0


BIORT_EXACT = ("legall", "near_sym_a", "antonini", "near_sym_b")


def biort_pair(name: str) -> tuple[np.ndarray, np.ndarray, bool]:
    """(h0o, g0o, is_exact_published) in the DC-gain-1 convention."""
    if name == "legall":
        return _LEGALL_H0, _LEGALL_G0, True
    if name == "near_sym_a":
        return _NEAR_SYM_A_H0, _NEAR_SYM_A_G0, True
    if name == "near_sym_b":
        return _NEAR_SYM_B_H0, _NEAR_SYM_B_G0, True
    if name == "antonini":
        h0, g0 = _antonini_pair()
        return h0, g0, True
    raise KeyError(name)


# ---------------------------------------------------------------------------
# exact Q-shift tables (orthonormal; tree b = time reverse)
# ---------------------------------------------------------------------------

_QSHIFT_06 = np.array([
    0.03516384, 0.0, -0.08832942, 0.23389032, 0.76027237,
    0.58751830, 0.0, -0.11430184, 0.0, 0.0,
], np.float64)

_QSHIFT_B = np.array([
    0.00325314, -0.00388321, 0.03466035, -0.03887280, -0.11720389,
    0.27529538, 0.75614564, 0.56881042, 0.01186609, -0.10671180,
    0.02382538, 0.01702522, -0.00543948, -0.00455690,
], np.float64)

QSHIFT_EXACT = ("qshift_06", "qshift_b")
_QSHIFT_ALIASES = {"qshift_a": "qshift_06", "qshift_c": "qshift_b",
                   "qshift_d": "qshift_b", "qshift_b_bp": "qshift_b"}


# banks with NO published/derivable coefficient table in this
# environment (the toolbox ships them as .mat data only; unlike
# near_sym_b there is no transformation-of-variables construction to
# exploit) — requesting one substitutes a published neighbour and MUST
# be user-visible: a reference workflow naming
# these banks gets numerically different (still perfect-reconstruction)
# filters.
_QSHIFT_SUBSTITUTED = {"qshift_a": "qshift_06 (10-tap, 6 nonzero)",
                       "qshift_c": "qshift_b (14-tap)",
                       "qshift_d": "qshift_b (14-tap)"}


def _warn_substituted(name: str) -> None:
    if name in _QSHIFT_SUBSTITUTED:
        import warnings

        warnings.warn(
            f"Q-shift bank {name!r} has no published coefficient table in "
            f"this environment — substituting {_QSHIFT_SUBSTITUTED[name]}. "
            "Outputs stay perfect-reconstruction but differ numerically "
            "from pytorch_wavelets' toolbox tables.",
            UserWarning, stacklevel=3)


def qshift_scaling(name: str) -> tuple[np.ndarray, bool]:
    """(tree-a scaling filter h, is_exact_published). ``h`` sums to √2 and
    has unit norm (to published-table precision)."""
    _warn_substituted(name)
    resolved = _QSHIFT_ALIASES.get(name, name)
    if resolved == "qshift_06":
        return _QSHIFT_06, name == "qshift_06"
    if resolved == "qshift_b":
        return _QSHIFT_B, name == "qshift_b"
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def qshift_tree_banks(name: str) -> tuple[WaveletFilters, WaveletFilters]:
    """(tree_a, tree_b) orthonormal banks from a published Q-shift table
    (same delay structure as dtcwt.qshift_banks: tree a from rev(h),
    tree b from h → analysis delays (L-1)/2 ∓ 1/4)."""
    h, _ = qshift_scaling(name)
    h = h / np.linalg.norm(h)
    if h.sum() < 0:
        h = -h
    return (_orthogonal_bank(f"{name}_a", h[::-1].copy()),
            _orthogonal_bank(f"{name}_b", h))


# ---------------------------------------------------------------------------
# biort pair → periodization filter bank (offset search, pure numpy)
# ---------------------------------------------------------------------------


def _np_afb1d(x, dec_lo, dec_hi):
    """Numpy mirror of the DWT's periodization analysis (1D)."""
    L = len(dec_lo)
    n = len(x)
    idx = np.arange(-(L - 1), n + L - 1) % n
    xp = x[idx]
    if L > 1:
        xp = xp[1:]
    outs = []
    for f in (dec_lo, dec_hi):
        fr = f[::-1]
        m = (len(xp) - L) // 2 + 1
        c = np.array([np.dot(xp[2 * i:2 * i + L], fr) for i in range(m)])
        outs.append(c[: n // 2])
    return outs


def _np_sfb1d(lo, hi, rec_lo, rec_hi, out_len):
    L = len(rec_lo)
    m = len(lo)
    p = max(1, (L + 1) // 2)
    idx = np.arange(-p, m + p) % m
    lo, hi = lo[idx], hi[idx]
    up = np.zeros(2 * len(lo))
    up[0::2] = lo
    uh = np.zeros(2 * len(hi))
    uh[0::2] = hi
    full = (np.convolve(up, rec_lo) + np.convolve(uh, rec_hi))
    start = (L - 2 + 2 * p) if L > 2 else 2 * p
    return full[start:start + out_len]


@functools.lru_cache(maxsize=None)
def biort_level1_bank(name: str) -> WaveletFilters:
    """Assemble a published biort pair into the filter-bank convention the
    periodization kernels expect (same scheme as dtcwt.near_sym_bank:
    dh = rl with even taps negated, rh = dl with odd taps negated;
    offsets found by an exact numpy PR search)."""
    h0, g0, _ = biort_pair(name)
    h0 = h0 * (np.sqrt(2.0) / h0.sum())
    g0 = g0 * (np.sqrt(2.0) / g0.sum())
    rng = np.random.default_rng(0)
    x = rng.standard_normal(32)
    best = None
    for L in range(max(len(h0), len(g0)) + 1, max(len(h0), len(g0)) + 5):
        if L % 2:
            continue
        for oh in range(L - len(h0) + 1):
            for og in range(L - len(g0) + 1):
                dl = np.zeros(L)
                dl[oh:oh + len(h0)] = h0
                rl = np.zeros(L)
                rl[og:og + len(g0)] = g0
                dh = rl.copy()
                dh[0::2] *= -1
                rh = dl.copy()
                rh[1::2] *= -1
                lo, hi = _np_afb1d(x, dl, dh)
                err = np.abs(_np_sfb1d(lo, hi, rl, rh, len(x)) - x).max()
                if best is None or err < best[0]:
                    best = (err, dl, dh, rl, rh)
        if best is not None and best[0] < 1e-10:
            break
    err, dl, dh, rl, rh = best
    if err > 1e-8:
        raise RuntimeError(f"no PR offset assembly found for {name} "
                           f"(best err {err:.2e})")
    return WaveletFilters(name, dl, dh, rl, rh)
