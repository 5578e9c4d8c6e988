"""Whitaker pyramid noise in one pass: kernels B4 and B5 beside their plain
versions (port of ``sonar_tpu.kernels.fused_pyramid``).

B4, the upscale pyramid (``pyramid``, replaces ``_make_kernel``,
fused_pyramid.py:100)::

    out[bc] = g1 + g2 + Σ_{i≥1} discountⁱ · Wh_i · small_i[bc] · Ww_iᵀ

where ``g1 + g2`` is the full-size base pair (ladder level 0 is the
identity and is folded into it) and ``Wh_i``/``Ww_i`` are the exact
interpolation matrices of :func:`~sonar_tpu_torch.ops.resample._resize_matrix`.
The plain version multiplies by the dense matrices; the kernel takes their
sparse rows (:func:`~sonar_tpu_torch.ops.resample.resize_taps`, at most four
taps an axis) and gathers, which skips exact zeros and nothing else.

B5, the downscale ladders (``highres_pyramid``, ``pyramid_old``; replaces
``_make_down_kernel``, fused_pyramid.py:264). At a scale of 2× or more per
axis the taps of different output pixels are disjoint, so each oversized
iid-gaussian level is, per output pixel, fresh fields: one for an identity,
``nearest`` or ``nearest-exact`` level, one times ``1/√block`` for ``area``
at an integer scale, four with the 2-tap bilinear weights for
``bilinear``. The oversized level is never built. B5 is two kernels that
compute the same bits: one that spreads a group's fields over the warps of a
block, for outputs too small to fill the card with a thread a group, and one
thread a group beyond; :func:`downscale_variant` picks by the element count
alone.

Streams (all Philox, :mod:`.hwrng`): ``fused_pyramid`` draws its base pair
in-kernel from ``derive_seed(seed, "base")`` on streams 0 and 1, and each
small level ``i ≥ 1`` with :func:`~.hwrng.philox_randn` (kernel B3) from
``derive_seed(seed, "draw", i)``. ``fused_downscale_pyramid`` draws the field
of (level ``l``, plane ``p``) from ``seed`` on stream ``4l + p``, planes in
the order g00, g01, g10, g11. The plain versions draw the same fields with
the plain Philox, so a kernel and its plain version agree element by element
for one seed. With ``planes=(first, run, stride)`` (a rank's block of a
sharded latent, ``parallel.LatentShard.plane_runs``) both kernels draw each
field at the global planes' indices: B4 its base pair, B5 every field, in
both of its kernels, also where a Philox group of four straddles two
ranks' blocks.

The gates ``fused_pyramid_supported``/``fused_downscale_supported`` are pure
functions of the configuration, the same on the CPU and the card. They keep
the JAX gates' mathematical conditions and drop the TPU tiling ones
(``h % 8 == 0``, ``w >= 8``): the CUDA kernels mask their own ragged edges.
They add the kernels' ladder limit of ``MAX_LEVELS`` levels.

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
``launches``), runs the plain version for CPU tensors, and raises on
anything the kernel cannot take.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import torch

from ..core.rng import derive_seed
from ..ops.resample import _resize_separable, _resize_taps, resize_taps
from .fused import _check_cuda
from .hwrng import check_shard, philox_key, philox_randn, philox_randn_reference

MAX_LEVELS = 16  # kernel parameter arrays (csrc/fused_pyramid.cu kMaxLevels)
MAX_TAPS = 4  # nonzeros in a row of an upscaling matrix (csrc/fused_pyramid.cu kMaxTaps)
UP_MODES = ("bilinear", "bicubic", "nearest", "nearest-exact", "area")
DOWN_MODES = ("bilinear", "nearest", "nearest-exact", "area")
_LEVEL0_DISCOUNT = 1.0  # level 0 (the identity) folded into the base pair
# B5: up to this many output elements the spread kernel (a warp a field, 32
# groups a block) takes the draw, beyond it one thread a group. Set where
# the two kernels' device times cross on an H100 80GB HBM3 at 700 W
# (kernel_times.py): at 65,536 elements the spread kernel takes 2.12 and
# 3.67 us (pyramid_old, highres) against 2.68 and 5.18, at 98,304 2.61 and
# 5.57 against 2.74 and 5.29, at 131,072 3.04 and 6.11 against 2.79 and 5.33.
DOWN_SPREAD_ELEMS = 96 * 1024


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the kernels receive it."""
    return float(np.float32(x))


def _check_input(name: str, t: torch.Tensor, ndim: int):
    _check_cuda(name, t, dtypes=(torch.float32,))
    if t.dim() != ndim:
        raise ValueError(f"{name}: the kernel needs a {ndim}-D tensor, "
                         f"got shape {tuple(t.shape)}")


def fused_pyramid_supported(sizes, h: int, w: int, mode: str) -> bool:
    """B4 covers the standard ladder: level 0 is ``(h, w)`` (the identity),
    every level is at most ``(h, w)``, the mode is separable."""
    return (
        1 <= len(sizes) <= MAX_LEVELS + 1
        and tuple(sizes[0]) == (h, w)
        and all(sh <= h and sw <= w for sh, sw in sizes)
        and mode in UP_MODES
    )


def fused_downscale_supported(sizes, h: int, w: int, mode: str) -> bool:
    """B5: every level is the identity or a ≥ 2× downscale per axis (tap
    injectivity) in a supported mode; ``area`` also needs integer scales, so
    its blocks partition the source (see :func:`_area_std`)."""
    if not 1 <= len(sizes) <= MAX_LEVELS or mode not in DOWN_MODES:
        return False
    for sh, sw in sizes:
        if sh == h and sw == w:
            continue
        if sh < 2 * h or sw < 2 * w:
            return False
        if mode == "area" and (sh % h or sw % w):
            return False
    return True


def _area_std(sh: int, sw: int, h: int, w: int) -> float:
    """Area downscale of iid N(0,1) at an integer scale: each output pixel
    averages an exclusive (sh/h)×(sw/w) block, so it is a fresh field with
    std 1/√(block size)."""
    return 1.0 / math.sqrt((sh // h) * (sw // w))


def _call_kernel(entry: str, *args):
    """Call a C entry point on the current stream; raise if it failed."""
    from ._build import check, load_library

    lib = load_library()
    err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    check(lib, err, entry)


# ---------------------------------------------------------------------------
# B4: the upscale pyramid
# ---------------------------------------------------------------------------


def _field_shard(planes, h: int, w: int):
    """The element slice of a field of ``h × w`` planes, from its plane slice."""
    return None if planes is None else tuple(v * h * w for v in planes)


def _pyramid_smalls(seed: int, bc: int, sizes, device, randn, planes=None):
    return [randn(derive_seed(seed, "draw", i), (bc, sh, sw), device=device,
                  **({} if planes is None else {"shard": _field_shard(planes, sh, sw)}))
            for i, (sh, sw) in enumerate(sizes) if i >= 1]


def fused_pyramid_accumulate_reference(base, smalls, discounts, mode="bilinear"):
    """Plain PyTorch version of B4 on a given (BC, H, W) base."""
    _, h, w = base.shape
    out = base
    for small, d in zip(smalls, discounts):
        out = out + _resize_separable(small, w, h, mode) * _f32(d)
    return out


def fused_pyramid_reference(seed: int, shape, sizes, discount: float,
                            mode: str = "bilinear", *, device, planes=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_pyramid`, on the same stream."""
    b, c, h, w = shape
    bseed = derive_seed(seed, "base")
    sh = _field_shard(planes, h, w)
    base = (philox_randn_reference(bseed, (b * c, h, w), device=device, stream=0, shard=sh)
            + philox_randn_reference(bseed, (b * c, h, w), device=device, stream=1, shard=sh)
            * _LEVEL0_DISCOUNT)
    smalls = _pyramid_smalls(seed, b * c, sizes, device, philox_randn_reference, planes)
    discounts = [discount**i for i in range(1, len(sizes))]
    return fused_pyramid_accumulate_reference(base, smalls, discounts,
                                              mode).reshape(b, c, h, w)


def _call_taps(sizes, h: int, w: int, mode: str) -> int:
    """The tap-table width of one B4 call: the widest row of any level's
    row or column matrix, padded up to 1, 2 or 4 (the kernel's
    instantiations)."""
    widest = max((_resize_taps(i, o, mode)[0].shape[1]
                  for sh, sw in sizes for i, o in ((sh, h), (sw, w))), default=1)
    if widest > MAX_TAPS:
        raise ValueError(f"fused_pyramid: rows of {widest} taps to {h}x{w} in mode "
                         f"{mode!r} (the kernel takes {MAX_TAPS})")
    return 1 if widest == 1 else 2 if widest == 2 else MAX_TAPS


def _launch_up(out, base, smalls, discounts, mode, key, shard=None):
    """Launch B4 on the levels' tap tables (the sparse rows of their
    interpolation matrices); the dense matrices never reach the kernel."""
    bc, h, w = out.shape
    n = len(smalls)
    taps = _call_taps([s.shape[-2:] for s in smalls], h, w, mode)
    ptrs = (ctypes.c_int64 * max(1, 5 * n))()
    dims = (ctypes.c_int * max(1, 2 * n))()
    disc = (ctypes.c_float * max(1, n))()
    for i, (small, d) in enumerate(zip(smalls, discounts)):
        sh, sw = small.shape[-2:]
        ridx, rval = resize_taps(sh, h, mode, device=out.device, taps=taps)  # (h, taps)
        cidx, cval = resize_taps(sw, w, mode, device=out.device, taps=taps)  # (w, taps)
        ptrs[5 * i:5 * i + 5] = [small.data_ptr(), ridx.data_ptr(), rval.data_ptr(),
                                 cidx.data_ptr(), cval.data_ptr()]
        dims[2 * i:2 * i + 2] = [sh, sw]
        disc[i] = d
    k0, k1 = key if key is not None else (0, 0)
    first, run, stride = shard if shard is not None else (0, 0, 0)
    with torch.cuda.device(out.device):
        _call_kernel("sonar_pyramid_up",
                     None if base is None else base.data_ptr(), out.data_ptr(),
                     bc, h, w, n, taps, ptrs, dims, disc, int(key is not None), k0, k1,
                     _LEVEL0_DISCOUNT, first, run, stride)


def fused_pyramid(seed: int, shape, sizes, discount: float, mode: str = "bilinear",
                  *, device, planes=None) -> torch.Tensor:
    """One ``pyramid`` draw of ``shape`` (B, C, H, W): the small levels
    ``i ≥ 1`` from kernel B3, then kernel B4 with the base pair drawn
    in-kernel. ``sizes`` is the ladder (``sizes[0] == (H, W)``).

    ``planes=(first, run, stride)``: the draw is the slice of a larger one
    whose planes (the B·C leading planes, row-major) local plane ``i`` is
    plane ``first + (i // run)·stride + i % run`` of (a rank's shard; see
    ``parallel.LatentShard.plane_runs``); every level and the base pair are
    drawn at the global planes' indices."""
    b, c, h, w = shape
    if not fused_pyramid_supported(sizes, h, w, mode):
        raise ValueError(f"fused_pyramid: ladder {sizes} in mode {mode!r} is not "
                         f"supported for {h}x{w}")
    device = torch.device(device)
    if device.type == "cpu":
        return fused_pyramid_reference(seed, shape, sizes, discount, mode,
                                       device=device, planes=planes)
    if device.type != "cuda":
        raise ValueError(f"fused_pyramid: no kernel for device {device}")
    smalls = _pyramid_smalls(seed, b * c, sizes, device, philox_randn, planes)
    out = torch.empty((b * c, h, w), dtype=torch.float32, device=device)
    _launch_up(out, None, smalls, [discount**i for i in range(1, len(sizes))], mode,
               philox_key(derive_seed(seed, "base")), _field_shard(planes, h, w))
    fused_pyramid.launches += 1
    return out.reshape(b, c, h, w)


def fused_pyramid_accumulate(base, smalls, discounts, mode: str = "bilinear"):
    """B4 on a given (BC, H, W) base: ``base + Σ dᵢ · up(smallᵢ)``."""
    if base.device.type == "cpu":
        return fused_pyramid_accumulate_reference(base, smalls, discounts, mode)
    _check_input("base", base, 3)
    bc, h, w = base.shape
    if mode not in UP_MODES or len(smalls) > MAX_LEVELS or len(smalls) != len(discounts):
        raise ValueError(f"fused_pyramid_accumulate: {len(smalls)} levels in mode "
                         f"{mode!r} (at most {MAX_LEVELS}, modes {UP_MODES})")
    for i, s in enumerate(smalls):
        _check_input(f"smalls[{i}]", s, 3)
        if s.shape[0] != bc or s.shape[1] > h or s.shape[2] > w or s.device != base.device:
            raise ValueError(f"smalls[{i}]: shape {tuple(s.shape)} does not fit "
                             f"{tuple(base.shape)}")
    out = torch.empty_like(base)
    _launch_up(out, base, list(smalls), [float(d) for d in discounts], mode, None)
    fused_pyramid_accumulate.launches += 1
    return out


fused_pyramid.launches = 0
fused_pyramid_accumulate.launches = 0


# ---------------------------------------------------------------------------
# B5: the downscale ladders
# ---------------------------------------------------------------------------


def _down_levels(sizes, coefs, h: int, w: int, mode: str):
    """Per level (planes, coef, ratio_h, ratio_w), in float32 as B5 takes them."""
    levels = []
    for (sh, sw), coef in zip(sizes, coefs):
        if (sh == h and sw == w) or mode in ("nearest", "nearest-exact"):
            levels.append((1, _f32(coef), 0.0, 0.0))
        elif mode == "area":
            levels.append((1, _f32(coef * _area_std(sh, sw, h, w)), 0.0, 0.0))
        else:
            levels.append((4, _f32(coef), _f32(sh / h), _f32(sw / w)))
    return levels


def _down_weights(out_len: int, ratio: float, device):
    """The 2-tap bilinear weights from the index, in float32, with
    ``_resize_matrix``'s coordinate ``(o + 0.5)·ratio − 0.5``
    (fused_pyramid.py:250-261)."""
    o = torch.arange(out_len, dtype=torch.float32, device=device)
    x = (o + 0.5) * ratio - 0.5
    f = x - torch.floor(x)
    return 1.0 - f, f


def _downscale_reference(fields, bc, h, w, sizes, coefs, mode, base, device):
    acc = (base.reshape(bc, h, w) if base is not None
           else torch.zeros((bc, h, w), dtype=torch.float32, device=device))
    for li, (planes, coef, rh, rw) in enumerate(_down_levels(sizes, coefs, h, w, mode)):
        g = fields(li, planes)
        if planes == 1:
            acc = acc + g[0] * coef
            continue
        wr0, wr1 = (t[:, None] for t in _down_weights(h, rh, device))
        wc0, wc1 = _down_weights(w, rw, device)
        lvl = wr0 * (wc0 * g[0] + wc1 * g[1]) + wr1 * (wc0 * g[2] + wc1 * g[3])
        acc = acc + lvl * coef
    return acc


def fused_downscale_accumulate_reference(g_fields, shape_hw, sizes, coefs,
                                         mode="bilinear", base=None):
    """Plain PyTorch version of B5 on given (BC, 4, H, W) tap fields."""
    h, w = shape_hw
    bc = g_fields[0].shape[0] if g_fields else base.shape[0]
    device = g_fields[0].device if g_fields else base.device
    return _downscale_reference(lambda li, n: [g_fields[li][:, p] for p in range(n)],
                                bc, h, w, sizes, coefs, mode, base, device)


def fused_downscale_pyramid_reference(seed: int, shape, sizes, coefs,
                                      mode: str = "bilinear", base=None, *,
                                      device=None, planes=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_downscale_pyramid`, on the same
    stream (``device`` defaults to ``base``'s)."""
    b, c, h, w = shape
    device = torch.device(device) if device is not None else base.device
    sh = _field_shard(planes, h, w)

    def fields(li, n):
        return [philox_randn_reference(seed, (b * c, h, w), device=device,
                                       stream=4 * li + p, shard=sh) for p in range(n)]

    return _downscale_reference(fields, b * c, h, w, sizes, coefs, mode, base,
                                device).reshape(b, c, h, w)


def downscale_variant(n: int) -> int:
    """Which of kernel B5's two kernels takes an output of ``n`` elements: 1,
    the spread kernel (a block owns 32 Philox groups and has a warp for
    every field of the ladder, so a thread makes one Philox call), 2, one
    thread a group walking the ladder. Both add the levels in ladder order,
    so the choice moves no bit."""
    return 1 if n <= DOWN_SPREAD_ELEMS else 2


_forced_variant = None


@contextlib.contextmanager
def _forced_down_variant(variant):
    """Inside the block B5's launches use kernel ``variant`` (1 or 2; None:
    the wrapper's pick) whatever the size. For tests and timings only: the
    result is the same bits."""
    global _forced_variant
    before, _forced_variant = _forced_variant, variant
    try:
        yield
    finally:
        _forced_variant = before


def _launch_down(out, base, g_fields, sizes, coefs, mode, key, shard=None):
    bc, h, w = out.shape
    variant = _forced_variant or downscale_variant(out.numel())
    levels = _down_levels(sizes, coefs, h, w, mode)
    n = len(levels)
    ptrs = (ctypes.c_int64 * max(1, n))()
    planes = (ctypes.c_int * max(1, n))()
    params = (ctypes.c_float * max(1, 3 * n))()
    for i, (p, coef, rh, rw) in enumerate(levels):
        ptrs[i] = g_fields[i].data_ptr() if g_fields is not None else 0
        planes[i] = p
        params[3 * i:3 * i + 3] = [coef, rh, rw]
    k0, k1 = key if key is not None else (0, 0)
    first, run, stride = check_shard(shard, out.numel()) if shard is not None else (0, 0, 0)
    with torch.cuda.device(out.device):
        _call_kernel("sonar_pyramid_down",
                     None if base is None else base.data_ptr(), out.data_ptr(),
                     bc, h, w, n, ptrs, planes, params, int(key is not None), k0, k1,
                     int(variant), first, run, stride)


def _check_base(base, bc, h, w):
    if base is not None:
        _check_cuda("base", base, dtypes=(torch.float32,))
        if base.numel() != bc * h * w:
            raise ValueError(f"base: shape {tuple(base.shape)} != {(bc, h, w)}")


def fused_downscale_pyramid(seed: int, shape, sizes, coefs, mode: str = "bilinear",
                            base=None, *, device=None, planes=None) -> torch.Tensor:
    """One highres_pyramid / pyramid_old draw of ``shape`` (B, C, H, W) by
    kernel B5, fields drawn in-kernel; ``base`` (any shape of B·C·H·W
    elements, e.g. highres_pyramid's inner draw) is added in.
    :func:`downscale_variant` picks which of B5's two kernels runs.

    ``planes=(first, run, stride)``: the draw is the slice of a larger one
    (a rank's shard), as :func:`fused_pyramid`'s: every field is drawn at its
    global planes' indices, also where a Philox group of four straddles two
    ranks' blocks."""
    b, c, h, w = shape
    if not fused_downscale_supported(sizes, h, w, mode):
        raise ValueError(f"fused_downscale_pyramid: ladder {sizes} in mode {mode!r} "
                         f"is not supported for {h}x{w}")
    device = torch.device(device) if device is not None else base.device
    if device.type == "cpu":
        return fused_downscale_pyramid_reference(seed, shape, sizes, coefs, mode,
                                                 base, device=device, planes=planes)
    if device.type != "cuda":
        raise ValueError(f"fused_downscale_pyramid: no kernel for device {device}")
    _check_base(base, b * c, h, w)
    out = torch.empty((b * c, h, w), dtype=torch.float32, device=device)
    _launch_down(out, base, None, sizes, coefs, mode, philox_key(seed),
                 _field_shard(planes, h, w))
    fused_downscale_pyramid.launches += 1
    return out.reshape(b, c, h, w)


def fused_downscale_accumulate(g_fields, shape_hw, sizes, coefs, mode: str = "bilinear",
                               base=None) -> torch.Tensor:
    """B5 on given tap fields, one (BC, 4, H, W) tensor per level (planes
    g00, g01, g10, g11; single-field levels read plane 0)."""
    device = g_fields[0].device if g_fields else base.device
    if device.type == "cpu":
        return fused_downscale_accumulate_reference(g_fields, shape_hw, sizes, coefs,
                                                    mode, base)
    h, w = shape_hw
    bc = g_fields[0].shape[0] if g_fields else base.shape[0]
    if mode not in DOWN_MODES or not (len(g_fields) == len(sizes) == len(coefs)
                                      <= MAX_LEVELS):
        raise ValueError(f"fused_downscale_accumulate: {len(g_fields)} fields for "
                         f"{len(sizes)} levels in mode {mode!r}")
    for i, g in enumerate(g_fields):
        _check_input(f"g_fields[{i}]", g, 4)
        if tuple(g.shape) != (bc, 4, h, w) or g.device != device:
            raise ValueError(f"g_fields[{i}]: shape {tuple(g.shape)} != {(bc, 4, h, w)}")
    _check_base(base, bc, h, w)
    out = torch.empty((bc, h, w), dtype=torch.float32, device=device)
    _launch_down(out, base, g_fields, sizes, coefs, mode, None)
    fused_downscale_accumulate.launches += 1
    return out


fused_downscale_pyramid.launches = 0
fused_downscale_accumulate.launches = 0
