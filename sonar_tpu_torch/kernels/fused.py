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
3. :func:`scale_noise_moments`, :func:`scale_noise_m2` and
   :func:`scale_noise_apply` — B2 split in three launches for a latent that
   spans ranks: the shard's count and sum, then (after the ranks'
   all_reduce) its squared deviations about the global mean, then (after a
   second all_reduce) the affine with the global mean, std and dead-band.
   The statistics stay in device memory as float64 tensors between the
   launches; ``core.normalize.scale_noise`` runs the three with the
   collectives between them.

Each wrapper sends a CUDA tensor to its kernel, or raises if the kernel
cannot take it, and a CPU tensor to the plain PyTorch version beside it.
Both kernels take float32, bfloat16 and float16 latents: they load each
element into float32, compute there and store in the latent's type, as the
TPU kernels' float32 scalars promote their arithmetic.
There is no fallback from one to the other. Each wrapper counts its kernel
launches in a plain integer attribute, ``launches``, so a run can show that
it went through the kernel; the plain version does not count.

The views the CPU path takes, the card takes too. A CUDA tensor that is not
contiguous (a transpose, a slice, ``channels_last``, the output of
``irfft2``) is copied once into a contiguous one and then goes through the
kernel; the wrapper counts these copies in ``copies``. The kernels compute
in float32 and have no float64 instantiation: a float64 CUDA tensor, like
any other element type they do not take, raises ``TypeError``. Nothing on
the card is ever handed to the plain version.
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


def _contiguous(wrapper, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: itself, or one counted contiguous copy."""
    if t.is_contiguous():
        return t
    wrapper.copies += 1
    return t.contiguous()


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
    x, denoised, hd, noise = (_contiguous(fused_momentum_step, t) if t.is_cuda else t
                              for t in (x, denoised, hd, noise))
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
fused_momentum_step.copies = 0


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
    if noise.is_cuda:
        noise = _contiguous(fused_scale_noise, noise)
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
fused_scale_noise.copies = 0


# ---------------------------------------------------------------------------
# B2 split: the global statistics of a latent that spans ranks
# ---------------------------------------------------------------------------


def scale_noise_moments_reference(noise):
    """Plain version of :func:`scale_noise_moments`: ``[N, Σx]`` in float64."""
    return torch.stack([torch.full((), noise.numel(), dtype=torch.float64, device=noise.device),
                        noise.float().sum(dtype=torch.float64)])


def scale_noise_m2_reference(noise, moments):
    """Plain version of :func:`scale_noise_m2`: ``[Σ(x − mean)²]`` in float64,
    the mean ``float32(Σx / N)`` of the (reduced) moments."""
    mean = (moments[1] / moments[0]).float()
    return (noise.float() - mean).square().sum(dtype=torch.float64).reshape(1)


def scale_noise_apply_reference(noise, moments, m2, factor=1.0, *,
                                threshold_std_devs: float = 2.5):
    """Plain version of :func:`scale_noise_apply`: B2's dead-band and affine
    with the mean, std and threshold of the whole latent's statistics."""
    count = moments[0]
    mean = (moments[1] / count).float()
    std = torch.sqrt(m2[0] / (count - 1.0)).float()
    threshold = (threshold_std_devs / torch.sqrt(count)).float()
    dt = noise.dtype
    x = noise.float()
    x = torch.where(mean.abs() > threshold, x - mean, x)
    x = torch.where(((1.0 - std).abs() > threshold) & (std != 0),
                    x / torch.where(std == 0, torch.ones_like(std), std), x)
    return (x * factor).to(dt)


def _split_launch(wrapper, step: int, noise, moments=None, stats=None, out=None,
                  threshold_std_devs: float = 2.5, factor: float = 1.0):
    if noise.is_cuda:
        noise = _contiguous(wrapper, noise)
    _check_cuda("noise", noise)
    for name, t in (("moments", moments), ("stats", stats)):
        if t is not None:
            _check_cuda(name, t, dtypes=(torch.float64,))
            if t.device != noise.device:
                raise ValueError(f"{name}: device {t.device} != {noise.device}")
    if noise.numel() == 0:
        raise ValueError(f"{wrapper.__name__}: an empty shard")
    from ._build import check, load_library

    lib = load_library()
    with torch.cuda.device(noise.device):
        err = lib.sonar_scale_noise_split(
            step, noise.data_ptr(), None if out is None else out.data_ptr(), noise.numel(),
            None if moments is None else moments.data_ptr(), stats.data_ptr(),
            threshold_std_devs, float(factor), _aligned16(noise), _DTYPE_CODES[noise.dtype],
            torch.cuda.current_stream().cuda_stream)
    check(lib, err, wrapper.__name__)
    wrapper.launches += 1


def scale_noise_moments(noise):
    """This shard's ``[N, Σx]`` as a (2,) float64 tensor on its device: one
    launch of one block (sums in float32 a thread, float64 across)."""
    if noise.device.type == "cpu":
        return scale_noise_moments_reference(noise)
    stats = torch.empty(2, dtype=torch.float64, device=noise.device)
    _split_launch(scale_noise_moments, 0, noise, stats=stats)
    return stats


def scale_noise_m2(noise, moments):
    """This shard's ``[Σ(x − mean)²]`` as a (1,) float64 tensor, the mean
    that of ``moments`` (the whole latent's, after the all_reduce), read in
    device memory: one launch of one block."""
    if noise.device.type == "cpu":
        return scale_noise_m2_reference(noise, moments)
    stats = torch.empty(1, dtype=torch.float64, device=noise.device)
    _split_launch(scale_noise_m2, 1, noise, moments=moments, stats=stats)
    return stats


def scale_noise_apply(noise, moments, m2, factor=1.0, *, threshold_std_devs: float = 2.5):
    """B2's dead-band and affine on this shard with the whole latent's
    statistics (``moments`` and ``m2`` reduced over the ranks): the mean,
    the ddof=1 std and the threshold ``threshold_std_devs/√N`` of the global
    N are computed in the kernel from device memory, so the host waits for
    nothing."""
    if noise.device.type == "cpu":
        return scale_noise_apply_reference(noise, moments, m2, factor,
                                           threshold_std_devs=threshold_std_devs)
    if m2.dtype != torch.float64 or m2.shape != (1,):
        raise ValueError(f"m2: expected (1,) float64, got {tuple(m2.shape)} {m2.dtype}")
    if noise.is_cuda:
        noise = _contiguous(scale_noise_apply, noise)
    out = torch.empty_like(noise)
    _split_launch(scale_noise_apply, 2, noise, moments=moments, stats=m2, out=out,
                  threshold_std_devs=threshold_std_devs, factor=factor)
    return out


for _f in (scale_noise_moments, scale_noise_m2, scale_noise_apply):
    _f.launches = 0
    _f.copies = 0
