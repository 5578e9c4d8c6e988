#!/usr/bin/env python3
"""Device times of the port's redesigned kernels (B2, B3, B4, B6) on one NVIDIA GPU.

    python3 kernel_times.py

A one-minute companion to ``chip_smoke.py`` for work on a kernel: it builds
the kernels, then prints, per shape and option, the kernel's own device time
per call (``torch.profiler``, the mean of 20 calls) beside the least time
the card could take for the same work (``chip_smoke.py``'s bounds):

- B2 (scale_noise) one element under, at and over each size where its
  launch changes (one block at 1×4×64×64, one cluster up to 4×4×128×128,
  one cooperative grid beyond) and at 64, 4,096, 1×4×128×128 and
  1×4×2304×2048 elements, in float32, bfloat16 and float16, with the device
  kernels a call launches;
- B3 (Philox gaussian) at 1×4×64×64, 2²⁰ and 1×4×2304×2048 elements,
  normals and uniforms, in float32, bfloat16 and float16, beside
  ``torch.randn`` and ``torch.rand`` on the same shape and type;
- B4 (upscale pyramid) at 1×4×64×64 and 4×4×512×512, in the bilinear,
  bicubic and nearest modes with the base pair drawn in-kernel, and in
  bilinear on a given base;
- B6 (k smallest toroidal distances) at 1×4×64×64 and 1×4×128×128 with 256
  points and at 4×4×512×512 with 32, k in {1, 2, 4, 8}, euclidean and
  minkowski.

It checks nothing: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
the kernels against their plain versions. It needs one CUDA device and
imports nothing of JAX.
"""

import sys

import chip_smoke as CS


def main():
    import torch

    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import sonar_tpu_torch.kernels.fused as F
    import sonar_tpu_torch.kernels.fused_pyramid as P
    import sonar_tpu_torch.kernels.voronoi as V
    import sonar_tpu_torch.noise.generators as G
    from sonar_tpu_torch.kernels import _build
    from sonar_tpu_torch.kernels import hwrng as H

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.load_library()

    def alone(fn, pattern, iters=20):
        _, by = CS.device_us(torch, fn, iters)
        return sum(v for k, v in by.items() if pattern in k)

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    for dt in dtypes:
        size = torch.empty(0, dtype=dt).element_size()
        caps = (F.SCALE_NOISE_BLOCK_ELEMS, F.SCALE_NOISE_CLUSTER_ELEMS)
        counts = sorted({64, 4096, 65536, 18874368, *(c + d for c in caps for d in (-1, 0, 1))})
        for n in counts:
            x = (torch.randn(n, device=dev) * 1.3 + 0.2).to(dt)
            us, _ = CS.device_us(torch, lambda: F.fused_scale_noise(x), 20)
            bd = CS.b2_bound(n, size)
            print(f"B2 {n} elements {dt}: tier {F.scale_noise_tier(n, size)}, "
                  f"{CS.device_us.launched:.0f} device kernel a call, {us:.2f} us (bound "
                  f"{bd['us']:.2f} us by {bd['by']}) [{card}]")
        del x

    for n in (16384, 1 << 20, 18874368):
        for dt in dtypes:
            for what, ours, theirs in (("normal", H.philox_randn, torch.randn),
                                       ("uniform", H.philox_rand, torch.rand)):
                us = alone(lambda: ours(5, (n,), device=dev, dtype=dt), "philox_fill")
                lib_us, _ = CS.device_us(torch, lambda: theirs((n,), device=dev, dtype=dt), 20)
                bd = CS.b3_bound(n, dt.itemsize) if what == "normal" else CS.bound(
                    dt.itemsize * n, CS.PHILOX_INSTR * n)
                print(f"B3 {n} elements {dt} {what}: {us:.2f} us (bound {bd['us']:.2f} us "
                      f"by {bd['by']}), torch.{theirs.__name__} {lib_us:.2f} us [{card}]")

    for shape in ((1, 4, 64, 64), (4, 4, 512, 512)):
        lad = G._size_ladder_pyramid(shape[2], shape[3], 10, 0)
        disc = [0.7**i for i in range(1, len(lad))]
        for mode in ("bilinear", "bicubic", "nearest"):
            us = alone(lambda: P.fused_pyramid(5, shape, lad, 0.7, mode, device=dev),
                       "pyramid_up_kernel")
            bd = CS.b4_bound(shape, lad, mode, gen=True)
            print(f"B4 {shape} {mode}, base drawn in-kernel: {us:.2f} us (bound "
                  f"{bd['us']:.2f} us by {bd['by']}) [{card}]")
        base = torch.randn((shape[0] * shape[1], *shape[2:]), device=dev)
        smalls = [torch.randn((base.shape[0], sh, sw), device=dev) for sh, sw in lad[1:]]
        us = alone(lambda: P.fused_pyramid_accumulate(base, smalls, disc), "pyramid_up_kernel")
        bd = CS.b4_bound(shape, lad, "bilinear", gen=False)
        print(f"B4 {shape} bilinear, given base: {us:.2f} us (bound {bd['us']:.2f} us by "
              f"{bd['by']}) [{card}]")

    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, n in (((1, 4, 64, 64), 256), ((1, 4, 128, 128), 256), ((4, 4, 512, 512), 32)):
        fp = torch.rand((shape[0], shape[1], n, 3), generator=gen, device=dev)
        ys = torch.arange(shape[2], dtype=torch.float32, device=dev) / shape[2]
        xs = torch.arange(shape[3], dtype=torch.float32, device=dev) / shape[3]
        z = torch.tensor(0.25, device=dev)
        for dist in ("euclidean", "minkowski"):
            for k in (1, 2, 4, 8):
                us = alone(lambda: V.voronoi_ksmallest(fp, ys, xs, z, scale=2.0, k=k,
                                                       dist=dist), "voronoi_ksmallest_kernel")
                bd = CS.b6_bound(shape, n, k)
                print(f"B6 {shape} N={n} {dist} k={k}: {us:.2f} us (bound {bd['us']:.2f} us "
                      f"by {bd['by']}) [{card}]")


if __name__ == "__main__":
    sys.exit(main())
