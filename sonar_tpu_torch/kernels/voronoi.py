"""The k smallest toroidal distances per pixel: kernel B6 beside its plain
version (port of ``sonar_tpu.kernels.voronoi``).

The Voronoi generator's hot loop computes, per output pixel, the toroidal 3D
distances to N feature points and reads a small ordered prefix of them (the
f/diff result modes). The plain version builds the (B, C, H, W, N) distance
tensor axis by axis and takes ``torch.topk(largest=False)``; the kernel
(``csrc/voronoi.cu``; replaces ``_make_kernel`` of the JAX package) keeps the
k smallest per pixel in registers and never builds it.

The plain version first computes, with the JAX package's operations
(voronoi.py:186-201), the scaled and wrapped grid vectors ``gy``, ``gx``, the
scaled point coordinates, and the per-point z term ``dz`` in the form the
distance adds it (squared, ``|.|`` or ``|.|^p``): :func:`_prepare`. The
kernel starts from the caller's tensors and repeats all of it in its
prologue and table fill, operation by operation in the same order, so the
two agree bit for bit for euclidean, quadratic and chebyshev (the kernel
selects on the squared euclidean distance and takes k roots at the end:
``sqrt`` is correctly rounded, hence monotone); minkowski's powers are
``powf`` in both on the card, and the host's ``pow`` differs from it by an
ulp. No torch op runs between the caller and the launch.

:func:`voronoi_ksmallest` runs the plain version on a CPU tensor and the
kernel on a CUDA tensor, or raises; it counts kernel launches in
``launches``. The gate :func:`voronoi_kernel_supported` is a function of the
configuration alone.
"""

from __future__ import annotations

import torch

DISTS = ("euclidean", "quadratic", "chebyshev", "minkowski")
MAX_K = 8
_MAX_PLANES = 65535  # the grid's y dimension


def voronoi_kernel_supported(h: int, w: int, k: int, dist: str, bc: int, n: int) -> bool:
    """Whether B6 computes this call: one of the four distances, a prefix
    of at most eight and at most N (with fewer points than the prefix the
    kernel would leave +inf where the plain path's indexing stays finite),
    and at most 65,535 planes. The JAX gate's conditions on the TPU's tiling
    (``h % 8``, the SMEM budget) do not apply: B6 stages the points in
    chunks and masks the ragged edge. Every prefix length is the kernel's,
    f1's single distance included."""
    return (dist in DISTS and 0 < k <= MAX_K and k <= n
            and h >= 1 and w >= 1 and 1 <= bc <= _MAX_PLANES)


def _prepare(fp, ys, xs, z_norm, *, scale, dist, p, weights):
    """(gy, gx, fy, fx, dz) in float32 on fp's device, with the JAX
    package's operations (kernels/voronoi.py:186-201). fy, fx, dz: (BC, N)."""
    b, c, n, _ = fp.shape
    wz = float(weights[2])
    fm = (fp.to(torch.float32) * scale) % 1.0
    fy = fm[..., 0].reshape(b * c, n).contiguous()
    fx = fm[..., 1].reshape(b * c, n).contiguous()
    gy = (ys.to(torch.float32) * scale) % 1.0
    gx = (xs.to(torch.float32) * scale) % 1.0
    gz = (torch.as_tensor(z_norm, dtype=torch.float32, device=fp.device) * scale) % 1.0
    dzw = ((gz - fm[..., 2] + 0.5) % 1.0 - 0.5) * wz
    if dist in ("euclidean", "quadratic"):
        dz = dzw * dzw
    elif dist == "chebyshev":
        dz = torch.abs(dzw)
    else:  # minkowski
        dz = torch.abs(dzw) ** p
    return gy.contiguous(), gx.contiguous(), fy, fx, dz.reshape(b * c, n).contiguous()


def _check_call(fp, ys, xs, k, dist):
    b, c, n, three = fp.shape
    h, w = ys.shape[0], xs.shape[0]
    if three != 3 or ys.ndim != 1 or xs.ndim != 1:
        raise ValueError(f"voronoi_ksmallest: fp must be (B, C, N, 3) and ys, xs 1-D, "
                         f"got {tuple(fp.shape)}, {tuple(ys.shape)}, {tuple(xs.shape)}")
    if not voronoi_kernel_supported(h, w, k, dist, b * c, n):
        raise ValueError(f"voronoi_ksmallest: k={k}, dist={dist!r}, N={n}, "
                         f"planes={b * c}, {h}x{w} is not supported")


def voronoi_ksmallest_reference(fp, ys, xs, z_norm, *, scale: float, k: int,
                                dist: str = "euclidean", p: float = 3.0,
                                weights=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Plain PyTorch version of kernel B6: the per-axis distance tensor (the
    operations of the JAX package's per-axis path) and ``torch.topk``."""
    _check_call(fp, ys, xs, k, dist)
    b, c, n, _ = fp.shape
    h, w = ys.shape[0], xs.shape[0]
    wy, wx = float(weights[0]), float(weights[1])
    gy, gx, fy, fx, dz = _prepare(fp, ys, xs, z_norm, scale=scale, dist=dist, p=p,
                                  weights=weights)
    dy = ((gy.view(1, h, 1, 1) - fy.view(b * c, 1, 1, n) + 0.5) % 1.0 - 0.5) * wy
    dx = ((gx.view(1, 1, w, 1) - fx.view(b * c, 1, 1, n) + 0.5) % 1.0 - 0.5) * wx
    dz = dz.view(b * c, 1, 1, n)
    if dist == "euclidean":
        d = torch.sqrt(dy * dy + dx * dx + dz)
    elif dist == "quadratic":
        d = dy * dy + dx * dx + dz
    elif dist == "chebyshev":
        d = torch.maximum(torch.maximum(torch.abs(dy), torch.abs(dx)), dz)
    else:  # minkowski
        d = (torch.abs(dy) ** p + torch.abs(dx) ** p + dz) ** (1.0 / p)
    out = torch.topk(d, k, dim=-1, largest=False, sorted=True).values
    return out.reshape(b, c, h, w, k)


def voronoi_ksmallest(fp, ys, xs, z_norm, *, scale: float, k: int,
                      dist: str = "euclidean", p: float = 3.0,
                      weights=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """k smallest toroidal distances per pixel, ascending.

    ``fp``: (B, C, N, 3) feature points in [0, 1); ``ys``/``xs``: the
    (H,)/(W,) grid vectors (``arange(L) / L``); ``z_norm``: the grid's z, a
    number or a 0-dim tensor (kept on the device: no host sync). ``weights``
    multiply the wrapped per-axis differences. Returns (B, C, H, W, k)
    float32."""
    if fp.device.type == "cpu":
        return voronoi_ksmallest_reference(fp, ys, xs, z_norm, scale=scale, k=k,
                                           dist=dist, p=p, weights=weights)
    if fp.device.type != "cuda":
        raise ValueError(f"voronoi_ksmallest: no kernel for device {fp.device}")
    _check_call(fp, ys, xs, k, dist)
    if ys.device != fp.device or xs.device != fp.device:
        raise ValueError(f"voronoi_ksmallest: grid vectors on {ys.device} and {xs.device}, "
                         f"points on {fp.device}")
    b, c, n, _ = fp.shape
    h, w = ys.shape[0], xs.shape[0]
    # no-ops on the generator's float32 tensors; the grid vectors may be strided
    fp = fp.to(torch.float32).contiguous()
    ys, xs = ys.to(torch.float32), xs.to(torch.float32)
    z = torch.as_tensor(z_norm, dtype=torch.float32, device=fp.device).reshape(())
    from ._build import check, load_library

    lib = load_library()
    out = torch.empty((b, c, h, w, k), dtype=torch.float32, device=fp.device)
    with torch.cuda.device(fp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sonar_voronoi_ksmallest(
            ys.data_ptr(), ys.stride(0), xs.data_ptr(), xs.stride(0), fp.data_ptr(),
            z.data_ptr(), out.data_ptr(), b * c, n, h, w, k, DISTS.index(dist),
            float(scale), float(p), float(1.0 / p), float(weights[0]),
            float(weights[1]), float(weights[2]), stream)
    check(lib, err, "voronoi_ksmallest")
    voronoi_ksmallest.launches += 1
    return out


voronoi_ksmallest.launches = 0
