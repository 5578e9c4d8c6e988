"""FreeU-Extreme: power-filtered scaling of UNet block activations (port of
``sonar_tpu.cfg.freeu``; reference py/nodes/freeu_extreme.py).

Configs compile into ``block_patches`` for
:func:`sonar_tpu_torch.models.unet.unet_apply`: plain functions over NCHW
activations. The spectral filter ``irfft2(rfft2(x) · F)`` is one static
real linear map per (filter, shape), and the port has the JAX package's
three ways to apply it, all equal to each other:

- ``"dense"``: ``x_flat @ K`` with the (hw, hw) response matrix K, the
  default up to 32×32 (K is 4 MB there; it grows as (hw)²);
- ``"fft"``: ``torch.fft.rfft2`` · filter · ``irfft2`` with
  ``norm="ortho"``, the default above 32×32;
- ``"sep"``: the rank-decomposed pair ``Σ_r A[r] @ x @ B[r]``, opt-in up
  to 128×128 (it falls back to the FFT beyond, or when the mask's rank
  exceeds 64, as in the JAX package).

``ffilter(..., operator=)`` and ``make_freeu_patches(..., operator=)``
force one of them (dense K at any shape; the JAX package's
``SONAR_TPU_FREEU_MATMUL`` variable is not ported); ``None`` picks by shape
as the JAX package does.
The dense and ``sep`` products are exact float32 (JAX's
``precision="highest"``) whatever ``torch.backends.cuda.matmul.allow_tf32``
says; ``"dense_fast"`` and ``"sep_fast"`` (JAX's ``"fast"`` variants) allow
TF32. The filter surface, K and the factor pairs are built on the host in
float64, once per (filter, shape, normalization factor, operator, device),
and kept on that device.

The sampling-percentage window is a device-side select on the sigma the
patch sees (``ctx["sigma"]``), as the JAX package's traced select is: a
patched forward reads nothing back from the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..noise.power import PowerFilter

FFILTER_OPERATORS = ("dense", "dense_fast", "fft", "sep", "sep_fast")
_MATMUL_MAX_HW = 1024       # 32x32: the default takes dense K up to here
_SEPARABLE_MAX_HW = 16384   # 128x128 cap for the opt-in "sep"
_SEPARABLE_MAX_RANK = 64    # beyond this the factored FLOPs lose to FFT


def default_operator(h: int, w: int) -> str:
    """The JAX package's default: dense K up to 32×32, the FFT above."""
    return "dense" if h * w <= _MATMUL_MAX_HW else "fft"


def _ffilter_matrix(filt: np.ndarray, h: int, w: int) -> np.ndarray:
    """Dense (hw, hw) real operator with y_flat = x_flat @ K: row j is the
    filter's response to the j-th spatial basis image (float64 host FFTs,
    cast to float32 once)."""
    eye = np.eye(h * w, dtype=np.float64).reshape(h * w, h, w)
    spec = np.fft.rfft2(eye, norm="ortho") * np.asarray(filt, np.float64)
    return np.fft.irfft2(spec, s=(h, w), norm="ortho").reshape(
        h * w, h * w).astype(np.float32)


def _ffilter_factors(filt: np.ndarray, h: int, w: int, tol: float = 1e-7):
    """Rank-decomposed spectral operator: ``y = sum_r A[r] @ x @ B[r]`` with
    real (h,h)/(w,w) factor pairs, exact to rank truncation at float32 noise
    for any mask.

    A rank-1 mask u v^T separates the 2D spectral filter into an h-axis
    operator ``ifft . diag(u) . fft`` and a w-axis operator
    ``irfft . diag(v) . rfft``. The h-operator is real for h-symmetric u
    and imaginary for antisymmetric u; splitting the mask M = Ms + Ma into
    its symmetric and antisymmetric parts and taking the SVD of each gives
    only those two cases, and the real-linear irfft lift gives the matching
    right factors B1 = Cw Pv + Sw Qv (symmetric) / B2 = Cw Qv - Sw Pv
    (antisymmetric). PowerFilter masks are ~1e-4 asymmetric (the
    reference's off-center oversampling grid), so both branches matter.

    Returns (A, B) stacks of shape (R, h, h)/(R, w, w), or None when the
    total rank exceeds _SEPARABLE_MAX_RANK."""
    M = np.asarray(filt, np.float64)
    wr = M.shape[1]
    # spectral-basis responses (the norm cancels between forward and
    # inverse, so the composite equals the ortho-normalized FFT path)
    Fh = np.fft.fft(np.eye(h), axis=0)                 # columns: fft(e_j)
    RW = np.fft.rfft(np.eye(w), axis=1)                # rows: rfft(e_n)
    Cw, Sw = RW.real, RW.imag                          # (w, wr)
    P = np.fft.irfft(np.eye(wr), n=w, axis=1)          # (wr, w)
    Q = np.fft.irfft(1j * np.eye(wr), n=w, axis=1)     # (wr, w)
    flip = (-np.arange(h)) % h
    Ms = 0.5 * (M + M[flip])
    Ma = 0.5 * (M - M[flip])
    A_rows, B_rows = [], []
    scale = max(np.abs(M).max(), 1e-30)
    for part, anti in ((Ms, False), (Ma, True)):
        if np.abs(part).max() <= tol * scale:
            continue
        U, S, Vt = np.linalg.svd(part, full_matrices=False)
        keep = S > tol * max(S[0], tol * scale)
        for r in np.nonzero(keep)[0]:
            u, v = U[:, r] * S[r], Vt[r]
            A_c = np.fft.ifft(u[:, None] * Fh, axis=0)  # (h, h) complex
            Pv, Qv = v[:, None] * P, v[:, None] * Q
            if anti:
                # antisymmetric u: the h-operator is purely imaginary
                assert np.abs(A_c.real).max() < 1e-9 * (abs(S[0]) + 1)
                A_rows.append(A_c.imag)
                B_rows.append(Cw @ Qv - Sw @ Pv)
            else:
                assert np.abs(A_c.imag).max() < 1e-9 * (abs(S[0]) + 1)
                A_rows.append(A_c.real)
                B_rows.append(Cw @ Pv + Sw @ Qv)
    if not A_rows or len(A_rows) > _SEPARABLE_MAX_RANK:
        return None
    return (np.stack(A_rows).astype(np.float32),
            np.stack(B_rows).astype(np.float32))


@lru_cache(maxsize=64)
def _operator_tensors(pfilter: PowerFilter, h: int, w: int, normalization_factor: float,
                      kind: str, device: str):
    """The operator ``kind`` ("dense", "sep" or "fft") for a (h, w) slice as
    float32 tensors on ``device``: (K,), (A, B) or (filter,); None for a
    "sep" whose rank is too high."""
    filt = PowerFilter.normalize(pfilter.build((h, w)), (h, w),
                                 normalization_factor=normalization_factor)
    if kind == "dense":
        mats = (_ffilter_matrix(filt, h, w),)
    elif kind == "sep":
        mats = _ffilter_factors(filt, h, w)
        if mats is None:
            return None
    else:
        mats = (np.asarray(filt, np.float32),)
    return tuple(torch.as_tensor(m, device=device) for m in mats)


@contextlib.contextmanager
def _matmul_tf32(allow: bool):
    """cuBLAS float32 products with or without TF32 for the block, then the
    global switch as it was."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = allow
    try:
        yield
    finally:
        flags.allow_tf32 = old


def ffilter(x: torch.Tensor, pfilter: PowerFilter, normalization_factor: float = 1.0, *,
            operator: str | None = None) -> torch.Tensor:
    """rfft2 · filter · irfft2 in float32 over the last two axes
    (freeu_extreme.py:10-29), by ``operator`` (module docstring; None: by
    shape)."""
    h, w = x.shape[-2:]
    op = operator or default_operator(h, w)
    if op not in FFILTER_OPERATORS:
        raise ValueError(f"Unknown ffilter operator {op!r}; valid: {FFILTER_OPERATORS}")
    kind = op.removesuffix("_fast")
    key = (pfilter, h, w, float(normalization_factor))
    device = str(x.device)
    x32 = x.float()
    if kind == "dense":
        (k,) = _operator_tensors(*key, "dense", device)
        with _matmul_tf32(op.endswith("_fast")):
            out = torch.matmul(x32.reshape(*x.shape[:-2], h * w), k)
        return out.reshape(x.shape).to(x.dtype)
    if kind == "sep" and h * w <= _SEPARABLE_MAX_HW:
        factors = _operator_tensors(*key, "sep", device)
        if factors is not None:
            a, b = factors
            with _matmul_tf32(op.endswith("_fast")):
                t = torch.einsum("rij,...jk->r...ik", a, x32)
                out = torch.einsum("r...ik,rkl->...il", t, b)
            return out.to(x.dtype)
    (filt,) = _operator_tensors(*key, "fft", device)
    out = torch.fft.irfft2(torch.fft.rfft2(x32, norm="ortho") * filt, s=(h, w), norm="ortho")
    return out.to(x.dtype)


@dataclasses.dataclass
class FreeUExtremeConfig:
    """One filter rule (freeu_extreme.py:113-255). ``frux_config`` chains."""

    target: str = "backbone"  # backbone | skip | both
    stage_1: bool = True
    stage_2: bool = False
    stage_3: bool = False
    start: float = 0.0
    end: float = 1.0
    slice: float = 1.0
    slice_offset: float = 0.0
    filter_norm: float = 0.0
    scale: float = 1.0
    blend: float = 1.0
    blend_mode: str = "lerp"
    hidden_mean: bool = True
    final: bool = True
    sonar_power_filter: PowerFilter | None = None
    frux_config: "FreeUExtremeConfig | None" = None

    def get_config_list(self) -> list["FreeUExtremeConfig"]:
        result = [self]
        curr = self
        while (cfg := curr.frux_config) is not None:
            curr = cfg
            if (cfg.start >= 1 or cfg.end <= 0 or cfg.blend == 0
                    or not (cfg.stage_1 or cfg.stage_2 or cfg.stage_3)):
                continue
            result.append(cfg)
        result.reverse()
        return result

    def get_scale(self, h: torch.Tensor):
        """Scalar scale or FreeU-v2 hidden-mean per-pixel scale
        (freeu_extreme.py:187-197). ``h`` is NCHW."""
        if not self.hidden_mean:
            return self.scale
        hmean = h.mean(1, keepdim=True)
        flat = hmean.reshape(hmean.shape[0], -1)
        hmax = flat.amax(-1).reshape(-1, 1, 1, 1)
        hmin = flat.amin(-1).reshape(-1, 1, 1, 1)
        hmean = (hmean - hmin) / torch.where(hmax == hmin, 1.0, hmax - hmin)
        return 1.0 + (self.scale - 1.0) * hmean

    def stage_enabled(self, stage: int) -> bool:
        return bool(getattr(self, f"stage_{stage}"))

    def target_matches(self, is_skip: bool) -> bool:
        want = "skip" if is_skip else "backbone"
        return self.target in {want, "both"}

    def apply(self, x: torch.Tensor, apply_mask: torch.Tensor, *,
              operator: str | None = None) -> torch.Tensor:
        """The filtered, scaled channel slice blended back
        (freeu_extreme.py:205-230) where the one-element bool tensor ``apply_mask``
        holds (the pct window, not shadowed by an earlier matching ``final``
        config: the handler computes it). A new tensor; ``x`` is not
        written."""
        features = x.shape[1]
        slice_size = int(features * self.slice)
        slice_offs = int(features * self.slice_offset)
        scale = self.get_scale(x)
        xs = x[:, slice_offs : slice_offs + slice_size]
        if self.sonar_power_filter is not None:
            filtered = ffilter(xs, self.sonar_power_filter,
                               normalization_factor=self.filter_norm, operator=operator)
        else:
            filtered = xs
        xslice = filtered * scale  # the hidden-mean scale broadcasts over the slice
        if self.blend != 1.0:
            xslice = BLENDING_MODES[self.blend_mode](xs, xslice, self.blend)
        xslice = torch.where(apply_mask, xslice.to(x.dtype), xs)
        return torch.cat([x[:, :slice_offs], xslice, x[:, slice_offs + slice_size:]], dim=1)


def _stage_of(channels: int, model_channels: int) -> int | None:
    return {model_channels * 4: 1, model_channels * 2: 2, model_channels: 3}.get(channels)


def make_freeu_patches(*, model_sampling, model_channels: int,
                       input_config: FreeUExtremeConfig | None = None,
                       middle_config: FreeUExtremeConfig | None = None,
                       output_config: FreeUExtremeConfig | None = None,
                       operator: str | None = None) -> dict:
    """Build ``block_patches`` for :func:`sonar_tpu_torch.models.unet.unet_apply`
    (replaces FreeUExtremeNode's ModelPatcher installation,
    freeu_extreme.py:258-334). ``operator`` forces one spectral operator
    (:func:`ffilter`)."""
    icfg = () if input_config is None else tuple(input_config.get_config_list())
    mcfg = () if middle_config is None else tuple(middle_config.get_config_list())
    ocfg = () if output_config is None else tuple(output_config.get_config_list())

    def pct_of(ctx) -> torch.Tensor:
        # once a forward: every patch of it sees the same sigma. Kept (1,)
        # shaped: the table lookup then indexes with a 1-D tensor, a gather on
        # the device (a 0-dim index could be read back as a number)
        key = ("freeu_pct", id(model_sampling))
        if key not in ctx:
            sigma = torch.as_tensor(ctx["sigma"], dtype=torch.float32).reshape(-1)
            ctx[key] = 1.0 - model_sampling.timestep(sigma.amax(0, keepdim=True)) / 999.0
        return ctx[key]

    def handler(cfgs, x, ctx, is_skip=False, stage_channels=None):
        # the reference derives the skip tensor's stage from the BACKBONE
        # h's channel count, not the skip's own (freeu_extreme.py:311-313
        # passes h.shape for both): at channel-transition output blocks
        # they differ
        stage = _stage_of(x.shape[1] if stage_channels is None else int(stage_channels),
                          model_channels)
        if stage is None:
            return x
        active = [c for c in cfgs if c.stage_enabled(stage) and c.target_matches(is_skip)]
        if not active:
            return x
        pct = pct_of(ctx)
        # a config applies when its pct window matches AND no earlier
        # matching `final` config shadowed it; an out-of-window `final`
        # config does not stop the scan (the reference breaks only after a
        # matched final, freeu_extreme.py:199-203, 306-313)
        shadowed = None
        for cfg in active:
            in_window = (pct >= cfg.start) & (pct <= cfg.end)
            x = cfg.apply(x, in_window if shadowed is None else in_window & ~shadowed,
                          operator=operator)
            if cfg.final:
                shadowed = in_window if shadowed is None else shadowed | in_window
        return x

    patches: dict[str, list[Callable]] = {}
    if icfg:
        patches["input"] = [lambda h, ctx: handler(icfg, h, ctx)]
    if mcfg:
        patches["middle"] = [lambda h, ctx: handler(mcfg, h, ctx)]
    if ocfg:
        patches["output"] = [
            lambda h, hsp, ctx: (
                handler(ocfg, h, ctx),
                handler(ocfg, hsp, ctx, is_skip=True, stage_channels=h.shape[1]),
            )
        ]
    return patches
