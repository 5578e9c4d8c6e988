"""Noise normalization primitives (port of ``sonar_tpu.core.normalize``).

- ``tstd`` — Bessel-corrected std (ddof=1), the reference's statistic.
- ``scale_noise`` — the canonical mean-0/std-1 normalizer with a
  2.5/sqrt(N) significance dead-band (py/utils.py:85-106).
- ``normalize_to_scale`` — the min/max range remap (py/utils.py:452-470).
- ``tmedian`` — torch.median's lower-middle rule along one axis.
- ``tquantile``, ``tmode`` and ``quantile_normalize`` with its 37 outlier
  strategies (py/utils.py:124-449), the negative-quantile "centered" proxy
  mode included.

The data-dependent branches are ``torch.where`` selects on device values:
a Python ``if`` on a tensor would wait for the card once per noise draw.
The global mode is kernel B2's wrapper, so on a CUDA tensor it launches the
kernel and on a CPU tensor it runs the plain version.

``normalize_to_scale_adv`` remaps the negative and the positive values to
ranges of their own with masks (its auto-bounds are 0-dim device tensors).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Sequence

import torch

from ..kernels.fused import (fused_scale_noise, scale_noise_apply, scale_noise_m2,
                             scale_noise_moments)


def _static_one(factor) -> bool:
    return isinstance(factor, (int, float)) and factor == 1


def tstd(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Bessel-corrected std matching ``torch.Tensor.std`` (ddof=1)."""
    return torch.std(x, dim=dim, correction=1, keepdim=keepdim)


def tmedian(x: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """torch.median semantics: the lower of the two middle elements."""
    n = x.shape[axis]
    s = torch.sort(x, dim=axis).values
    return s.narrow(axis, (n - 1) // 2, 1) if keepdims else s.select(axis, (n - 1) // 2)


def _dims(dim, ndim: int):
    return tuple(range(ndim)) if dim is None else dim


def tquantile(x: torch.Tensor, q: float, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Linear-interpolation quantile with ``jnp.quantile``'s arithmetic: the
    position ``q * (n - 1)`` and the two weights in float32 (float64 for a
    float64 tensor), the two neighbours widened to it, ``lo * (1 - w) + hi *
    w``, and one rounding to the tensor's type (so a bfloat16 quantile is
    the JAX package's bit for bit, where ``torch.quantile`` refuses the
    type). Ties need no care: equal neighbours interpolate to themselves.
    The position is a host scalar: no call reads the card back."""
    if dim is None:
        out = tquantile(x.reshape(-1), q, dim=0)
        return out.reshape((1,) * x.ndim) if keepdim else out
    n = x.shape[dim]
    wide = torch.promote_types(x.dtype, torch.float32)
    pos = torch.tensor(q, dtype=wide) * (n - 1)
    lo, hi = (max(0, min(int(f(pos)), n - 1)) for f in (torch.floor, torch.ceil))
    w_hi = pos - lo
    s = torch.sort(x, dim=dim).values
    out = (s.narrow(dim, lo, 1).to(wide) * (1 - w_hi)
           + s.narrow(dim, hi, 1).to(wide) * w_hi).to(x.dtype)
    return out if keepdim else out.squeeze(dim)


def tmode(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Most frequent value along ``dim``, the smallest on ties (a sorted
    scan, as the JAX package's ``tmode``)."""
    moved = torch.movedim(x, dim, -1)
    s = torch.sort(moved.reshape(-1, moved.shape[-1]), dim=-1).values.contiguous()
    counts = (torch.searchsorted(s, s, side="right")
              - torch.searchsorted(s, s, side="left"))
    modes = s.gather(-1, counts.argmax(-1, keepdim=True)).reshape(moved.shape[:-1])
    return modes.unsqueeze(dim) if keepdim else modes


# ---------------------------------------------------------------------------
# quantile_normalize strategy handlers (py/utils.py:124-363)
# ---------------------------------------------------------------------------


def _qn_scaledown(noise, nq, *, dim, **_kw):
    noiseabs = torch.abs(noise)
    mv = torch.clamp(torch.amax(noiseabs, dim=_dims(dim, noise.ndim), keepdim=True),
                     min=1e-06)
    return torch.where(noiseabs > nq, noise * (nq / mv), noise)


def _qn_wave(noise, nq, *, preserve_sign=False, wave_function=torch.sin, pi_factor=0.5,
             wrong_mode=False, **_kw):
    if wrong_mode:
        multiplier = 1.0 / ((math.pi * pi_factor) / nq)
    else:
        multiplier = 1.0 / (nq / (math.pi * pi_factor))
    result = wave_function(noise * multiplier) * nq
    return torch.copysign(torch.abs(result), noise) if preserve_sign else result


def _qn_mode(noise, nq, *, dim, decimals=1, **_kw):
    scale = 10.0**decimals
    rounded = torch.round(noise * scale) / scale
    return torch.where(torch.abs(noise) > nq, tmode(rounded, dim=dim, keepdim=True), noise)


def _qn_replace(noise, nq, *, keep_sign=False, avoid_sign=False, count=1,
                count_flipping=False, **_kw):
    """py/utils.py:178-212: outliers are replaced by cycling through the
    inliers in their original order. torch's dynamic-shape ``noise[mask]``
    becomes a stable sort that packs the inliers to the front and a modular
    gather, so the inlier count stays on the device."""
    mask = torch.abs(noise) <= nq
    flat = noise.reshape(-1)
    fmask = torch.broadcast_to(mask, noise.shape).reshape(-1)
    order = torch.argsort((~fmask).to(torch.uint8), stable=True)
    packed = flat[order]
    n_cand = torch.clamp(fmask.sum(), min=1)
    idxs = torch.arange(flat.numel(), device=noise.device) % n_cand
    cresult = packed[idxs]
    if count >= 2:
        multiplier = 1.0 / count
        cresult = cresult * multiplier
        for i in range(1, count):
            shift = i if not count_flipping or (i % 2) == 0 else -i
            cresult = cresult + packed[torch.roll(idxs, shift)] * multiplier
    candidates = cresult.reshape(noise.shape)
    if keep_sign or avoid_sign:
        candidates = torch.copysign(torch.abs(candidates), -noise if avoid_sign else noise)
    return torch.where(mask, noise, candidates)


def _outliers(fn):
    """Apply ``fn`` where ``|noise| > nq``, keep the rest."""
    return lambda noise, nq, **kw: torch.where(torch.abs(noise) > nq, fn(noise, nq, **kw),
                                                noise)


_sigmoid_keepsign = lambda noise, nq, **_kw: torch.copysign(  # noqa: E731
    torch.sigmoid(noise) * torch.abs(nq), noise)

QUANTILE_HANDLERS: dict[str, Callable] = {
    "clamp": lambda noise, nq, **_kw: torch.clamp(noise, -nq, nq),
    "scale_down": _qn_scaledown,
    "tanh": lambda noise, nq, **_kw: torch.tanh(noise) * torch.abs(nq),
    "tanh_outliers": _outliers(lambda noise, nq, **_kw: torch.tanh(noise) * torch.abs(nq)),
    "sigmoid_keepsign": _sigmoid_keepsign,
    "sigmoid": lambda noise, nq, **_kw: torch.sigmoid(noise) * (torch.abs(nq) * 2)
    - torch.abs(nq),
    "sigmoid_outliers": _outliers(_sigmoid_keepsign),
    **{
        f"{name}{suffix}": partial(_qn_wave, wave_function=fn, **kw)
        for name, fn in (("sin", torch.sin), ("cos", torch.cos))
        for suffix, kw in (
            ("", {}),
            ("_wholepi", {"pi_factor": 1.0}),
            ("_keepsign", {"preserve_sign": True}),
            ("_wrong", {"wrong_mode": True}),
            ("_wrong_wholepi", {"pi_factor": 1.0, "wrong_mode": True}),
            ("_wrong_keepsign", {"preserve_sign": True, "wrong_mode": True}),
        )
    },
    "atan": lambda noise, nq, **_kw: torch.atan(noise) * (torch.abs(nq) / (math.pi / 2)),
    "tenth": _outliers(lambda noise, nq, **_kw: noise * 0.1),
    "half": _outliers(lambda noise, nq, **_kw: noise * 0.5),
    "zero": _outliers(lambda noise, nq, **_kw: torch.zeros_like(noise)),
    "reverse_zero": lambda noise, nq, **_kw: torch.where(torch.abs(noise) >= nq, noise, 0.0),
    "mean": _outliers(lambda noise, nq, *, dim, **_kw: noise.mean(
        dim=_dims(dim, noise.ndim), keepdim=True)),
    "median": _outliers(lambda noise, nq, *, dim, **_kw: tmedian(noise, axis=dim,
                                                                 keepdims=True)),
    "mode_1dec": partial(_qn_mode, decimals=1),
    "mode_2dec": partial(_qn_mode, decimals=2),
    **{
        f"replace{count}{flip}{sign}": partial(
            _qn_replace, count=n, count_flipping=bool(flip),
            keep_sign=sign == "_keepsign", avoid_sign=sign == "_avoidsign")
        for count, n in (("", 1), ("_2pt", 2), ("_3pt", 3))
        for flip in (("",) if n == 1 else ("", "_flip"))
        for sign in ("", "_keepsign", "_avoidsign")
        if not (n == 1 and flip)
    },
}


def quantile_normalize(
    noise: torch.Tensor,
    *,
    quantile: float | Sequence[float] = 0.75,
    dim: int | None = 1,
    flatten: bool = True,
    nq_fac: float = 1.0,
    pow_fac: float = 0.5,
    strategy: str = "clamp",
    strategy_handler: Callable | None = None,
    eps: float = 1e-08,
) -> torch.Tensor:
    """py/utils.py:367-449. ``quantile`` may be a list (applied in turn); a
    negative quantile switches to the "centered" proxy mode (near-zero
    values are treated as the outliers)."""
    if noise.numel() == 0:
        return noise
    if isinstance(quantile, (tuple, list)):
        for q in quantile:
            noise = quantile_normalize(
                noise, quantile=q, dim=dim, flatten=flatten, nq_fac=nq_fac,
                pow_fac=pow_fac, strategy=strategy, strategy_handler=strategy_handler)
        return noise
    if quantile is None or quantile >= 1 or quantile <= -1:
        return noise
    centered = quantile < 0
    absquantile = abs(quantile)
    orig_shape = noise.shape
    if noise.ndim > 1 and flatten and dim is not None:
        start = dim % noise.ndim
        flatnoise = noise.reshape(*noise.shape[:start], -1)
    else:
        flatten = False
        flatnoise = noise
    handler = QUANTILE_HANDLERS.get(strategy) if strategy_handler is None else strategy_handler
    if handler is None:
        valid = ", ".join(sorted(QUANTILE_HANDLERS))
        raise ValueError(f"Unknown strategy {strategy!r}; valid: {valid}")
    qaxis = -1 if flatten else dim
    if not centered:
        nq = tquantile(torch.abs(flatnoise), absquantile, dim=qaxis, keepdim=True)
        nq = nq * nq_fac + eps
        out = handler(flatnoise, nq, orig_noise=noise, dim=qaxis, flatten=flatten)
    else:
        absnoise = torch.abs(flatnoise)
        maxabs = torch.amax(absnoise, dim=_dims(qaxis, absnoise.ndim), keepdim=True)
        proxy = torch.sign(flatnoise) * (maxabs - absnoise)
        nq_proxy = tquantile(torch.abs(proxy), absquantile, dim=qaxis, keepdim=True)
        nq_proxy = nq_proxy * nq_fac + eps
        out_proxy = handler(proxy, nq_proxy, orig_noise=noise, dim=qaxis, flatten=flatten)
        out = torch.sign(out_proxy) * (maxabs - torch.abs(out_proxy))
    if pow_fac not in {0.0, 1.0}:
        out = torch.copysign(torch.abs(out) ** pow_fac, out)
    return out.reshape(orig_shape)


def normalize_to_scale(
    latent: torch.Tensor,
    target_min,
    target_max,
    *,
    dim=(-3, -2, -1),
    eps: float = 1e-07,
) -> torch.Tensor:
    """Range remap (py/utils.py:452-470). ``dim=None`` or ``()`` → global.
    The targets are numbers or tensors that broadcast (the Voronoi fuzz
    modes pass the 0-dim min and max of their input)."""
    if dim in (None, ()):
        min_val, max_val = latent.min(), latent.max()
    else:
        min_val = torch.amin(latent, dim=dim, keepdim=True)
        max_val = torch.amax(latent, dim=dim, keepdim=True)
    normalized = (latent - min_val) / ((max_val - min_val) + eps)
    return torch.clamp(normalized * (target_max - target_min) + target_min,
                       target_min, target_max)


def _clip(v: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with bounds that are numbers or 0-dim tensors, mixed."""
    v = torch.maximum(v, lo) if isinstance(lo, torch.Tensor) else v.clamp(min=lo)
    return torch.minimum(v, hi) if isinstance(hi, torch.Tensor) else v.clamp(max=hi)


def _masked_normalize_to_scale(t, mask, target_min, target_max, *, eps=1e-07):
    """normalize_to_scale over only the masked elements (global stats)."""
    big = torch.finfo(t.dtype).max
    min_val = torch.where(mask, t, big).min()
    max_val = torch.where(mask, t, -big).max()
    normalized = (t - min_val) / ((max_val - min_val) + eps)
    remapped = _clip(normalized * (target_max - target_min) + target_min,
                     target_min, target_max)
    return torch.where(mask, remapped, t)


def normalize_to_scale_adv(t: torch.Tensor, *, min_pos: float, max_pos: float,
                           min_neg: float, max_neg: float, dim=(-3, -2, -1)) -> torch.Tensor:
    """Separate ± range remap with auto-bounds (py/utils.py:473-510). The
    reference flattens each sign's values into one 1-D tensor, so its
    statistics are global over that sign whatever ``dim`` says; masks do
    the same here. ``max_neg >= 0`` takes the largest negative value as the
    bound and ``min_pos < 0`` the smallest positive one, as 0-dim tensors on
    the device."""
    del dim  # the reference's statistics are global (see above)
    skip_pos = max_pos <= 0 or min_pos >= max_pos
    skip_neg = min_neg >= 0 or min_neg >= max_neg
    neg_mask, pos_mask = t < 0.0, t > 0.0
    big = torch.finfo(t.dtype).max
    result = torch.zeros_like(t)
    if skip_neg:
        result = torch.where(neg_mask, t, result)
    else:
        mn = torch.where(neg_mask, t, -big).max() if max_neg >= 0 else max_neg
        result = torch.where(neg_mask, _masked_normalize_to_scale(t, neg_mask, min_neg, mn),
                             result)
    if skip_pos:
        result = torch.where(pos_mask, t, result)
    else:
        mp = torch.where(pos_mask, t, big).min() if min_pos < 0 else min_pos
        result = torch.where(pos_mask, _masked_normalize_to_scale(t, pos_mask, mp, max_pos),
                             result)
    return result


def scale_noise(
    noise: torch.Tensor,
    factor=1.0,
    *,
    normalized: bool = True,
    threshold_std_devs: float = 2.5,
    normalize_dims: tuple | None = None,
    shard=None,
) -> torch.Tensor:
    """THE normalizer (py/utils.py:85-106).

    Global mode: the mean is subtracted only if ``|mean| > 2.5/sqrt(N)``
    and the array is divided by the *original* std only if
    ``|1-std| > 2.5/sqrt(N)``, so noise that is already standard normal
    passes through untouched bit for bit.

    Per-dims mode: divide by the per-dims std, then subtract the
    post-division per-dims mean (that exact order, py/utils.py:96-99).

    Zero-std guard in both modes: constant noise passes through instead of
    the reference's 0/0 NaN.

    ``shard`` (a :class:`~sonar_tpu_torch.parallel.LatentShard`): ``noise``
    is this rank's block of a latent that spans ranks, and the statistics
    are the whole latent's, as GSPMD makes them for the JAX package. The
    global mode is then kernel B2 split in three launches with the ranks'
    sums between them (:func:`_scale_noise_sharded`); the per-dims mode is
    exact on the shard where no normalized dimension is split, and refused
    where one is.
    """
    if not normalized or noise.numel() == 0:
        return noise if _static_one(factor) else noise * factor
    if shard is not None and normalize_dims is None:
        return _scale_noise_sharded(noise, factor, shard, threshold_std_devs)
    if normalize_dims is not None:
        dims = tuple(normalize_dims)
        if shard is not None and any(shard.local_shape[d] != shard.global_shape[d]
                                     for d in dims):
            raise NotImplementedError(
                f"scale_noise: normalize_dims {dims} takes statistics across the split "
                f"dimensions of a latent sharded as {shard.local_shape} of "
                f"{shard.global_shape}")
        std = tstd(noise, dim=dims, keepdim=True)
        noise = noise / torch.where(std == 0, torch.ones_like(std), std)
        noise = noise - noise.mean(dim=dims, keepdim=True)
        return noise if _static_one(factor) else noise * factor
    return fused_scale_noise(noise, factor, threshold_std_devs=threshold_std_devs)


def _scale_noise_sharded(noise, factor, shard, threshold_std_devs: float):
    """The global mode on a shard: B2's two passes over the whole latent,
    each pass's sums reduced over the ranks. No step reads a value back."""
    from ..parallel.mesh import all_reduce

    moments = all_reduce(scale_noise_moments(noise), shard.groups)
    m2 = all_reduce(scale_noise_m2(noise, moments), shard.groups)
    return scale_noise_apply(noise, moments, m2, factor, threshold_std_devs=threshold_std_devs)
