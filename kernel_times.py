#!/usr/bin/env python3
"""Device times of the port's redesigned kernels, B4 and B6, on one NVIDIA GPU.

    python3 kernel_times.py

A one-minute companion to ``chip_smoke.py`` for work on a kernel: it builds
the kernels, then prints, per shape and option, the kernel's own device time
per call (``torch.profiler``, the mean of 20 calls) beside the least time
the card could take for the same work (``chip_smoke.py``'s bounds):

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
    import sonar_tpu_torch.kernels.fused_pyramid as P
    import sonar_tpu_torch.kernels.voronoi as V
    import sonar_tpu_torch.noise.generators as G
    from sonar_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.load_library()

    def alone(fn, pattern, iters=20):
        _, by = CS.device_us(torch, fn, iters)
        return sum(v for k, v in by.items() if pattern in k)

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
