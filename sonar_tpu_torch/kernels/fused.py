"""The sampler's two fused passes: CUDA kernels beside their plain versions.

1. :func:`fused_momentum_step` — the NEW-mode momentum chain
   ``d = (x − denoised)/σ → momentum mix → history update → x + m·dt`` plus
   the ancestral noise ``+ noise·noise_scale`` in one pass (kernel B1,
   ``csrc/fused.cu``; replaces ``_momentum_kernel`` of the JAX package).
2. :func:`fused_scale_noise` — scale_noise's global mode: mean and ddof=1
   std, the 2.5/√N dead-band, the affine and the factor (kernel B2; replaces
   ``_make_scale_noise_kernel``), in one launch that keeps the latent on
   chip between its passes; :func:`scale_noise_tier` picks the launch from
   the element count and size alone.

Each wrapper sends a CUDA tensor to its kernel, or raises if the kernel
cannot take it, and a CPU tensor to the plain PyTorch version beside it.
Both kernels take float32, bfloat16 and float16 latents: they load each
element into float32, compute there and store in the latent's type, as the
TPU kernels' float32 scalars promote their arithmetic.
There is no fallback from one to the other. Each wrapper counts its kernel
launches in a plain integer attribute, ``launches``, so a run can show that
it went through the kernel; the plain version does not count.
"""

from __future__ import annotations

import math

import torch

# B2's tiers, in elements: what one block takes, and what a cluster of 16
# blocks does. On an H100 the passes cost by the element on the few SMs of
# tiers 1 and 2, whatever its type, and from 262,145 elements on the
# cooperative grid's barriers cost less than the cluster's 16 SMs lose.
SCALE_NOISE_BLOCK_ELEMS = 16 * 1024
SCALE_NOISE_CLUSTER_ELEMS = 16 * SCALE_NOISE_BLOCK_ELEMS
_SCALE_NOISE_GRID_BLOCKS = 132  # tier 3's cooperative grid (kGridBlocks)


# The element types the kernels take, by the code their C entry points read.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_cuda(name: str, t: torch.Tensor, like: torch.Tensor | None = None,
                dtypes=tuple(_DTYPE_CODES)):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {[str(d) for d in dtypes]}, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if like is not None:
        if t.shape != like.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(like.shape)}")
        if t.device != like.device:
            raise ValueError(f"{name}: device {t.device} != {like.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != {like.dtype}")


def _aligned16(*ts: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


# ---------------------------------------------------------------------------
# B1: fused momentum step
# ---------------------------------------------------------------------------


def pack_momentum_scalars(*, sigma, dt, momentum, hd_ratio, hd_scale, md_scale,
                          has, noise_scale, in_window=True, hist_window=True,
                          device=None) -> torch.Tensor:
    """Stack the ten step scalars as float32, last axis of size 10.

    Each argument is a number, a bool or a 1-D tensor of per-step values;
    with any 1-D argument the result is a (steps, 10) table whose rows are
    the per-step scalar vectors. The samplers build one table per run and
    move it to the card once, so a step reads its row in place and needs no
    host round trip."""
    vals = (sigma, dt, momentum, hd_ratio, hd_scale, md_scale, has,
            noise_scale, in_window, hist_window)
    ts = torch.broadcast_tensors(*(torch.as_tensor(v).to(torch.float32) for v in vals))
    out = torch.stack(ts, dim=-1)
    return out if device is None else out.to(device)


def fused_momentum_step_reference(x, denoised, hd, noise, scal):
    """Plain PyTorch version of kernel B1 (the JAX package's
    fused_momentum_step_reference, in the same order of operations)."""
    (sigma, dt, momentum, hd_ratio, hd_scale, md_scale, has, noise_scale,
     in_window, hist_window) = scal.unbind(-1)
    dn_s = denoised / sigma
    hd1_blend = dn_s * md_scale + (hd * hd_scale - dn_s * md_scale) * hd_ratio
    hd1 = torch.where(hist_window > 0, torch.where(has > 0, hd1_blend, dn_s), hd)
    has1 = torch.maximum(has, hist_window)
    d = (x - denoised) / sigma
    mixed = hd1 + (d - hd1) * momentum
    momentum_d = torch.where(has1 > 0, mixed, d)
    momentum_d = torch.where(in_window > 0, momentum_d, d)
    hd2_blend = d * md_scale + (hd1 * hd_scale - d * md_scale) * hd_ratio
    new_hd = torch.where(hist_window > 0, torch.where(has1 > 0, hd2_blend, d), hd1)
    return momentum_d * dt + x + noise * noise_scale, new_hd


def fused_momentum_step(x, denoised, hd, noise, scal):
    """One-pass NEW-mode momentum + Euler step + noise injection.

    ``x``, ``denoised``, ``hd`` and ``noise`` share one dtype (float32,
    bfloat16 or float16); ``scal`` is the (10,) float32 vector of
    :func:`pack_momentum_scalars`, on the same device as ``x``. Returns
    ``(x', hd')`` in the dtype of ``x``."""
    if x.device.type == "cpu":
        return fused_momentum_step_reference(x, denoised, hd, noise, scal)
    for name, t in (("x", x), ("denoised", denoised), ("hd", hd), ("noise", noise)):
        _check_cuda(name, t, like=x)
    _check_cuda("scal", scal, dtypes=(torch.float32,))
    if scal.shape != (10,) or scal.device != x.device:
        raise ValueError(f"scal: expected (10,) on {x.device}, got "
                         f"{tuple(scal.shape)} on {scal.device}")
    from ._build import check, load_library

    lib = load_library()
    out_x = torch.empty_like(x)
    out_hd = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sonar_momentum_step(
            x.data_ptr(), denoised.data_ptr(), hd.data_ptr(), noise.data_ptr(),
            scal.data_ptr(), out_x.data_ptr(), out_hd.data_ptr(), x.numel(),
            _aligned16(x, denoised, hd, noise, out_x, out_hd), _DTYPE_CODES[x.dtype],
            stream)
    check(lib, err, "fused_momentum_step")
    fused_momentum_step.launches += 1
    return out_x, out_hd


fused_momentum_step.launches = 0


# ---------------------------------------------------------------------------
# B2: fused scale_noise
# ---------------------------------------------------------------------------


def fused_scale_noise_reference(noise, factor=1.0, *, threshold_std_devs: float = 2.5):
    """Plain PyTorch version of kernel B2: scale_noise's global mode.

    The dead-band branches are ``torch.where`` selects on device values, so
    no call waits for the card. Zero-std guard: constant noise passes
    through instead of dividing 0 by 0."""
    numel = noise.numel()
    if numel == 0:
        return noise if factor == 1 else noise * factor
    mean = noise.mean()
    std = noise.std(correction=1)
    threshold = threshold_std_devs / math.sqrt(numel)
    noise = torch.where(mean.abs() > threshold, noise - mean, noise)
    noise = torch.where(
        ((1.0 - std).abs() > threshold) & (std != 0),
        noise / torch.where(std == 0, torch.ones_like(std), std),
        noise,
    )
    return noise if factor == 1 else noise * factor


def scale_noise_tier(n: int, itemsize: int) -> int:
    """Which of kernel B2's launches takes a latent of ``n`` elements of
    ``itemsize`` bytes (4, or 2 for bfloat16 and float16): 1, one block that
    keeps the whole latent in its shared memory; 2, one cluster of 16
    blocks, each keeping its slice, their partial sums exchanged through
    distributed shared memory; 3, one cooperative grid of 132 blocks that
    keep what fits. It reads nothing else, so the reduction order, and with
    it every output bit, is a function of the shape and the element type.
    The limits are the same count for both sizes (see above)."""
    if itemsize not in (2, 4):
        raise ValueError(f"scale_noise_tier: the kernel takes 2- and 4-byte elements, "
                         f"not {itemsize}")
    if n <= SCALE_NOISE_BLOCK_ELEMS:
        return 1
    return 2 if n <= SCALE_NOISE_CLUSTER_ELEMS else 3


def fused_scale_noise(noise, factor=1.0, *, threshold_std_devs: float = 2.5):
    """scale_noise's global mode as one kernel launch.

    ``factor`` is a number. The threshold comes from N on the host; the
    mean, the std and the branch flags stay on the card. The kernel reads
    the latent once, keeps it (tiers 1 and 2) or part of it (tier 3) on chip
    for the squared deviations and the affine, and writes it once; it needs
    thread-block clusters (sm_90). :func:`scale_noise_tier` picks the launch."""
    if noise.device.type == "cpu":
        return fused_scale_noise_reference(noise, factor,
                                           threshold_std_devs=threshold_std_devs)
    _check_cuda("noise", noise)
    n = noise.numel()
    if n == 0:
        return noise if factor == 1 else noise * factor
    from ._build import check, load_library

    lib = load_library()
    tier = scale_noise_tier(n, noise.element_size())
    out = torch.empty_like(noise)
    # only tier 3's blocks meet through device memory
    part = (torch.empty(2 * _SCALE_NOISE_GRID_BLOCKS, dtype=torch.float32,
                        device=noise.device) if tier == 3 else None)
    with torch.cuda.device(noise.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sonar_scale_noise(
            noise.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
            n, tier, threshold_std_devs / math.sqrt(n), float(factor),
            _aligned16(noise, out), _DTYPE_CODES[noise.dtype], stream)
    check(lib, err, "fused_scale_noise")
    fused_scale_noise.launches += 1
    return out


fused_scale_noise.launches = 0
