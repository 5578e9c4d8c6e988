"""Dual-tree complex wavelet transform (DTCWT) in PyTorch (port of
``sonar_tpu.wavelets.dtcwt``; reference capability: pytorch_wavelets
DTCWTForward/Inverse via py/wavelet_functions.py:57-75, and ScatLayer).

Structure (the standard dual tree, in periodization mode):

- level 1: both trees use one odd-length biorthogonal pair (``biort``), and
  tree b filters the signal rolled by one sample along its axis;
- levels ≥ 2: tree a uses the q-shift filter (``qshift``), tree b its time
  reverse;
- 2D: the four (row tree, column tree) combinations aa, ab, ba, bb of each
  of the bands LH, HL, HH combine into six oriented complex subbands
  ``z1 = ((aa − bb) + j(ab + ba))/√2`` and ``z2 = ((aa + bb) + j(ab − ba))/√2``;
- inverse: unpack the four combinations, invert each tree (each is a
  perfect-reconstruction filter bank), average.

Each tree is the port's DWT (:mod:`.dwt`, gather, ``unfold`` and
product-sum): exact float32 on every device, whatever the TF32 switches say.
The subbands are ``complex64`` (``complex128`` for float64 input).

The named banks are the published ones of :mod:`.kingsbury`; ``native``
names the banks designed in the JAX package (the q-shift filter by BFGS on
a paraunitary lattice, :func:`qshift_filter`, built only when asked for and
cached).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .coeffs import WaveletFilters, _orthogonal_bank
from .dwt import _afb2d, _sfb2d

_SQRT2 = math.sqrt(2.0)

# ---------------------------------------------------------------------------
# q-shift filter design (numpy, as the JAX package designs it)
# ---------------------------------------------------------------------------


def _lattice_to_filter(thetas: np.ndarray) -> np.ndarray:
    """Paraunitary lattice → orthonormal scaling filter of length 2·len(thetas).
    Any angle vector yields an orthonormal two-channel bank (PR by
    construction)."""
    e0 = np.array([np.cos(thetas[0])])
    e1 = np.array([np.sin(thetas[0])])
    for th in thetas[1:]:
        e0d = np.concatenate([e0, [0.0]])
        e1d = np.concatenate([[0.0], e1])
        c, s = np.cos(th), np.sin(th)
        e0, e1 = c * e0d - s * e1d, s * e0d + c * e1d
    h = np.empty(2 * len(e0))
    h[0::2] = e0
    h[1::2] = e1
    return h * np.sqrt(2.0)  # DC gain √2 convention (‖h‖ = 1 → scaled)


def _qshift_objective(thetas: np.ndarray, length: int) -> float:
    h = _lattice_to_filter(thetas)
    n = np.arange(len(h))
    w_pass = np.linspace(0.01, np.pi * 0.45, 48)
    w_stop = np.linspace(np.pi * 0.6, np.pi, 48)
    E = np.exp(-1j * np.outer(w_pass, n))
    H = E @ h
    num = (E * n) @ h
    delay = np.real(num / np.where(np.abs(H) < 1e-8, 1e-8, H))
    target = (length - 1) / 2.0 - 0.25
    Es = np.exp(-1j * np.outer(w_stop, n))
    stop = np.abs(Es @ h) ** 2
    dc = (h.sum() - np.sqrt(2.0)) ** 2
    return (
        10.0 * float(np.mean((delay - target) ** 2))
        + 2.0 * float(np.mean(stop))
        + 50.0 * float(dc)
    )


@functools.lru_cache(maxsize=None)
def qshift_filter(length: int = 10) -> np.ndarray:
    """Design the tree-a q-shift scaling filter (even length): BFGS from 4
    seeded starts over the lattice angles; the passband group delay is
    pulled to the quarter-sample target (L−1)/2 − 1/4."""
    from scipy.optimize import minimize

    k = length // 2
    best_h, best_f = None, np.inf
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x0 = rng.uniform(-0.6, 0.6, k)
        x0[0] = np.pi / 4 + rng.uniform(-0.2, 0.2)
        res = minimize(_qshift_objective, x0, args=(length,), method="BFGS",
                       options={"maxiter": 400})
        if res.fun < best_f:
            best_f, best_h = res.fun, _lattice_to_filter(res.x)
    return best_h


@functools.lru_cache(maxsize=None)
def qshift_banks(length: int = 12) -> tuple[WaveletFilters, WaveletFilters]:
    """(tree_a, tree_b) orthonormal banks of the designed q-shift filter,
    renormalized to Σh = √2 / ‖h‖ = 1. The analysis correlates with the
    bank's scaling filter, so building tree a from rev(h) and tree b from h
    gives analysis delays (L−1)/2 ∓ 1/4: tree b lags tree a by the half
    sample the dual tree needs."""
    h = qshift_filter(length)
    h = h / np.linalg.norm(h)
    if h.sum() < 0:
        h = -h
    return (_orthogonal_bank("qshift_a_native", h[::-1].copy()),
            _orthogonal_bank("qshift_b_native", h))


# the JAX package's designed (13, 17)-tap near-symmetric level-1 pair
# (tools/design_nearsym.py): level-1 one-sidedness 0.941 with exact PR
_NEARSYM_H0 = np.array([  # analysis lowpass, 13 taps, symmetric
    0.02086858978935197, 0.05161814280931655, -0.04900413218788433,
    -0.18047282838505307, 0.09841321468146728, 0.4756072009396571,
    0.5801531870793837, 0.4756072009396571, 0.09841321468146728,
    -0.18047282838505307, -0.04900413218788433, 0.05161814280931655,
    0.02086858978935197,
])
_NEARSYM_G0 = np.array([  # synthesis lowpass, 17 taps, symmetric
    0.0, 0.08947134751275738, -0.2213060316903645, -0.09614112025933057,
    0.4918810179857031, -0.01761700970737806, -0.6282685810788478,
    0.37784017304724177, 1.4224939707535285, 0.37784017304724177,
    -0.6282685810788478, -0.01761700970737806, 0.4918810179857031,
    -0.09614112025933057, -0.2213060316903645, 0.08947134751275738, 0.0,
])


@functools.lru_cache(maxsize=None)
def near_sym_bank() -> WaveletFilters:
    """The designed near-sym (13, 17) pair in the filter-bank convention of
    the periodization DWT (the JAX package's offsets and parities)."""
    h0 = _NEARSYM_H0 * (np.sqrt(2.0) / _NEARSYM_H0.sum())
    g0 = _NEARSYM_G0 * (np.sqrt(2.0) / _NEARSYM_G0.sum())
    L = 18

    def pad(f, off):
        return np.concatenate([np.zeros(off), f, np.zeros(L - len(f) - off)])

    dl, rl = pad(h0, 2), pad(g0, 1)
    dh = rl.copy()
    dh[0::2] *= -1
    rh = dl.copy()
    rh[1::2] *= -1
    return WaveletFilters("near_sym_native", dl, dh, rl, rh)


@functools.lru_cache(maxsize=None)
def _resolve_level1(biort: str) -> WaveletFilters:
    """The level-1 bank of a biort name: the published tables, the ``_bp``
    names by their base bank (the bandpass-modified 45° filters are out of
    scope, as in the JAX package), ``native`` the designed pair."""
    from .kingsbury import biort_level1_bank

    if biort in ("legall", "near_sym_a", "antonini", "near_sym_b"):
        return biort_level1_bank(biort)
    if biort == "near_sym_a_bp":
        return biort_level1_bank("near_sym_a")
    if biort == "near_sym_b_bp":
        return biort_level1_bank("near_sym_b")
    if biort == "native":
        return near_sym_bank()
    raise ValueError(f"Unknown biort {biort!r}; valid: legall, near_sym_a, "
                     "antonini, near_sym_b, native")


@functools.lru_cache(maxsize=None)
def _resolve_qshift(qshift: str) -> tuple[WaveletFilters, WaveletFilters]:
    """(tree a, tree b) banks of a q-shift name (substituted names warn, in
    :func:`.kingsbury.qshift_scaling`)."""
    from .kingsbury import qshift_tree_banks

    if qshift in ("qshift_06", "qshift_a", "qshift_b", "qshift_c",
                  "qshift_d", "qshift_b_bp"):
        return qshift_tree_banks(qshift)
    if qshift == "native":
        return qshift_banks()
    raise ValueError(f"Unknown qshift {qshift!r}; valid: qshift_06, "
                     "qshift_a-qshift_d, native")


# ---------------------------------------------------------------------------
# forward / inverse
# ---------------------------------------------------------------------------

_TREES = ("aa", "ab", "ba", "bb")


def _mixed_banks(lvl: int, rt: str, ct: str, biort: str, qshift: str):
    """(bank along W, bank along H) of the tree (row tree ``rt``, column
    tree ``ct``) at level ``lvl``."""
    w1 = _resolve_level1(biort)
    qa, qb = _resolve_qshift(qshift)
    if lvl == 0:
        return w1, w1
    return (qa if ct == "a" else qb), (qa if rt == "a" else qb)


def _level1_shift(rt: str, ct: str, sign: int):
    """Tree b's one-sample roll at level 1 (rows for the row tree, columns
    for the column tree): the shifts and dims of ``torch.roll``."""
    shifts = (sign if rt == "b" else 0, sign if ct == "b" else 0)
    return shifts if any(shifts) else None


def _tree_dwt2d_mixed(x: torch.Tensor, level: int, rt: str, ct: str, biort: str, qshift: str):
    yl, yh = x, []
    for lvl in range(level):
        w_col, w_row = _mixed_banks(lvl, rt, ct, biort, qshift)
        if lvl == 0 and (shifts := _level1_shift(rt, ct, 1)):
            yl = torch.roll(yl, shifts, dims=(-2, -1))
        yl, bands = _afb2d(yl, w_col, "periodization", w_row)
        yh.append(bands)
    return yl, yh


def _tree_idwt2d_mixed(yl: torch.Tensor, yh, rt: str, ct: str, out_hw, biort: str,
                       qshift: str) -> torch.Tensor:
    x = yl
    n = len(yh)
    for j, bands in enumerate(reversed(yh)):
        lvl = n - 1 - j
        w_col, w_row = _mixed_banks(lvl, rt, ct, biort, qshift)
        bh, bw = bands.shape[-2:]
        if x.shape[-2:] != (bh, bw):
            x = x[..., :bh, :bw]
        x = _sfb2d(x, bands, w_col, "periodization", (bh * 2, bw * 2), w_row)
        if lvl == 0 and (shifts := _level1_shift(rt, ct, -1)):
            x = torch.roll(x, shifts, dims=(-2, -1))
    return x[..., : out_hw[0], : out_hw[1]]


def dtcwt2d(x: torch.Tensor, level: int = 3, *, biort: str = "near_sym_a",
            qshift: str = "qshift_a"):
    """Forward DTCWT of (B, C, H, W) → (yls, yhs):

    - ``yls``: tuple of the 4 real lowpasses (tree combinations aa, ab, ba, bb);
    - ``yhs``: list of ``level`` complex tensors shaped (B, C, 6, H_j, W_j),
      the 6 oriented subbands in pytorch_wavelets' order (15, 45, 75, 105,
      135 and 165 degrees)."""
    combos = {k: _tree_dwt2d_mixed(x, level, k[0], k[1], biort, qshift) for k in _TREES}
    yls = tuple(combos[k][0] for k in _TREES)
    yhs = []
    for j in range(level):
        baa, bab, bba, bbb = (combos[k][1][j] for k in _TREES)
        z1 = torch.complex((baa - bbb) / _SQRT2, (bab + bba) / _SQRT2)
        z2 = torch.complex((baa + bbb) / _SQRT2, (bab - bba) / _SQRT2)
        # z1/z2's band axis is (lh, hl, hh): orientations (lh, hh, hl) of z1,
        # then (hl, hh, lh) of z2
        yhs.append(torch.stack([z1[:, :, 0], z1[:, :, 2], z1[:, :, 1],
                                z2[:, :, 1], z2[:, :, 2], z2[:, :, 0]], dim=2))
    return yls, yhs


def _tree_bands(z: torch.Tensor, key: str) -> torch.Tensor:
    """One tree combination's (lh, hl, hh) bands from the 6 subbands."""
    n_or = z.shape[2] // 2
    za, zb = z[:, :, :n_or], z[:, :, n_or:]
    # undo the orientation order back to the per-tree (lh, hl, hh) axis
    z1 = torch.stack([za[:, :, 0], za[:, :, 2], za[:, :, 1]], dim=2)
    z2 = torch.stack([zb[:, :, 2], zb[:, :, 0], zb[:, :, 1]], dim=2)
    if key == "aa":
        return (z1.real + z2.real) / _SQRT2
    if key == "bb":
        return (z2.real - z1.real) / _SQRT2
    if key == "ab":
        return (z1.imag + z2.imag) / _SQRT2
    return (z1.imag - z2.imag) / _SQRT2  # ba


def idtcwt2d(yls, yhs, out_hw=None, *, biort: str = "near_sym_a",
             qshift: str = "qshift_a") -> torch.Tensor:
    """Inverse DTCWT: unpack the complex subbands into the 4 tree
    combinations, invert each (perfect reconstruction per tree), average."""
    if out_hw is None:
        out_hw = (yhs[0].shape[-2] * 2, yhs[0].shape[-1] * 2)
    out = None
    for ki, key in enumerate(_TREES):
        yh_tree = [_tree_bands(z, key) for z in yhs]
        x = _tree_idwt2d_mixed(yls[ki], yh_tree, key[0], key[1], out_hw, biort, qshift)
        out = x if out is None else out + x
    return out / 4.0


__all__ = ["dtcwt2d", "idtcwt2d", "near_sym_bank", "qshift_banks", "qshift_filter"]
