#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sonar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sonar_tpu_torch/csrc`` (into
``build/kernels/``, one ``nvcc`` per source, all at once), then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the kernel build time;
2. holds kernel B1 (fused momentum step) against its plain PyTorch version
   at the main path's shape and others, in every gate combination;
3. holds kernel B2 (fused scale_noise) against its plain version in every
   dead-band branch, on a tensor of more than 2**24 elements too, and checks
   that two runs agree bit for bit;
4. runs the main path — ``sample_sonar_euler_ancestral`` with the default
   SonarConfig and gaussian noise, 20 Karras steps (14.6 → 0.03, then 0) on
   a 1×4×64×64 latent, through the flagship ``UNetConfig()`` with random
   weights from a seed — and checks that it launched B1, B2 and B3 (the
   Philox gaussian) once per step; then runs one injected noise stream
   through the kernel path and through the plain path (composed momentum
   step, plain scale_noise), TF32 off, and compares the trajectories;
5. times both paths end to end and B1 and B2 against their plain versions
   with CUDA events;
6. holds kernel B3 (Philox4x32-10 Box-Muller) against its plain version:
   uniforms bit for bit, normals within 2e-6, on a ragged shape and on more
   than 2**24 elements, two calls equal, seeds distinct, and the moments;
7. holds kernel B4 (upscale pyramid) against its plain version on the
   64×64, 512×512, a ragged and a 263×260 ladder in five modes, base drawn
   in-kernel (same seed) and given, and on ladders that stress its tap tables
   (bicubic's clamped edges on 2- and 3-wide levels, widths that are not
   multiples of 4, a level as tall as the output, sixteen levels);
8. holds kernel B5 (downscale ladders) against its plain version on the
   highres_pyramid and pyramid_old ladders, with and without a base, fields
   drawn in-kernel and given;
9. runs the pyramid path — the sampler of phase 4 with
   ``SonarConfig(noise_type="pyramid")`` — and checks its launches (B3 once
   per small level and step, B4 once per step), then highres_pyramid and
   pyramid_old at 5 steps (B5 once per step); checks that one seed gives the
   same noise on the CPU (plain versions) and on the card (kernels) for
   gaussian and the three pyramids; and compares the pyramid path with the
   same sampler fed the plain versions' draws, TF32 off;
10. times the pyramid path, pyramid noise throughput, and B3, B4 and B5
   against their plain versions and the composed paths (B4's device time
   at 1×4×64×64 and 4×4×512×512 beside the composed path's);
11. holds kernel B6 (the k smallest toroidal distances of Voronoi noise)
   against its plain version: four distances, k in {1, 2, 4, 8}, N = 37,
   256 and 4,096 points (across its shared-memory chunks), the path's
   shape and ragged ones, axis weights and scale 8; then every tile height
   and point split, k = N = 8, 13 and 100 points, strided grid vectors;
12. runs the Voronoi path — the sampler of phase 4 with
   ``SonarConfig(noise_type="voronoi_mix")`` — and checks its launches (B6
   three times a step, once per octave; B3 four times a step and three
   times at set-up), reproducibility, and the trajectory against the
   sampler fed the plain versions' draws, TF32 off; then ``voronoi_fuzz``
   and a ``custom_noise`` NoiseChain of a VoronoiGenerator at 5 steps; and
   one seed's noise on the CPU (plain versions) and the card for all three;
13. holds B1 and B2 on bfloat16 and float16 latents against their plain
   versions and runs the bf16 headline (stub denoiser, 20 steps) through
   B1, B2 and B3, against ``use_fused=False``;
14. times the Voronoi path against the gaussian headline (with the launches
   and device time of one run of each), B6 against its plain version at
   the path's shape and at bench.py's Voronoi shape for k in {1, 2, 4, 8},
   f1 through B6 against the per-axis path, and Voronoi noise throughput.

Every phase passes or the script exits non-zero without a result. Before
the last line it prints one JSON object listing the six kernels with their
launches on the paths, their error, their device time (``ms``), the plain
version's, the least time the card could take (``bound_ms``, from this
run's shapes: bytes at 3.35 TB/s against operations at 33.5 T/s, the
67 TFLOP/s fp32 peak counted as fused multiply-adds) and, where one PyTorch
route computes the same function, its time (``library_ms``). The last
line is ``{"ok": true, "device": {...}}``. It needs one CUDA device and no
network, and imports nothing of JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

STEPS = 20
SHORT_STEPS = 5
SHAPE = (1, 4, 64, 64)
B1_SHAPES = [(1, 4, 64, 64), (4, 4, 128, 128), (1, 4, 67, 61), (1, 3, 67, 61)]
B2_SHAPES = [(1, 4, 64, 64), (4, 4, 128, 128), (1, 4, 67, 61), (1, 4, 2304, 2048)]
B3_SHAPES = [(1, 4, 64, 64), (1, 4, 67, 61), (1, 4, 2304, 2048)]
B3_SEEDS = [(0, 0), (7, 0), (2**40 + 3, 5)]  # (seed, stream)
PYR_HW = [(64, 64), (512, 512), (67, 61), (263, 260)]
DOWN_HW = [(64, 64), (128, 128), (67, 61)]
B1_TOL = 1e-6  # relative to max(1, |plain|): elementwise, same order of operations
B2_TOL = 1e-5  # relative to max(1, |plain|): mean/std summed in another order
B3_TOL = 2e-6  # absolute on normals up to ~5.7: libdevice vs host log/cos/sin ulps
PYR_TOL = 1e-5  # relative to max(1, |plain|): B4 sums in another order, B3's ulps
XDEV_TOL = 1e-5  # relative to max(1, |cpu|): one seed, CPU plain vs card kernels
TRAJ_TOL = 1e-4  # relative to max |trajectory|, TF32 off on both paths
B6_SHAPES = [(1, 4, 64, 64), (1, 3, 67, 61), (2, 2, 9, 130)]
B6_POINTS = [37, 256, 4096]
# every tile height B6 picks (4, 8, 16, 32 rows), with few points too
B6_TILE_SHAPES = [(1, 1, 8, 8), (1, 3, 128, 128), (1, 2, 256, 160), (4, 4, 128, 128)]
B6_TILE_POINTS = [8, 13, 100]
# B4 ladders beyond the generator's: (h, w), the levels below the base
PYR_EDGE = [((8, 6), [(3, 2), (2, 3), (1, 1)]),
            ((5, 7), [(5, 3), (1, 7), (2, 2)]),
            ((33, 130), [(33, 47), (12, 130), (3, 3), (1, 1)]),
            ((16, 18), [(max(1, 16 - i), max(1, 18 - 2 * i)) for i in range(1, 17)])]
HBM_BYTES_S = 3.35e12  # H100 SXM, published
INSTR_S = 33.5e12  # 67 TFLOP/s fp32, a fused multiply-add counted as two
B6_TOL = 1e-6  # minkowski only, relative to max(1, |plain|); the rest bit for bit
# bf16/fp16: one ulp of the working type against the plain version on the
# float32 upcast (relative to max(1, |plain|)); against the plain version
# run in the working type, which rounds each of its ~10 steps
LOW_TOL = {"bfloat16": (2.0**-7, 2.0**-4), "float16": (2.0**-10, 2.0**-7)}
BF16_TRAJ_TOL = 0.1  # relative to max |trajectory|: 20 steps of bf16 carries
VORONOI_BENCH = (1, 4, 128, 128)  # bench.py:852, 256 points


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def need(cond, msg: str):
    if not cond:
        fail(msg)


def rel_err(a, b):
    err = float((a.double() - b.double().to(a.device)).abs().max())
    return err, err / max(1.0, float(b.double().abs().max()))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_sigmas(torch, steps=STEPS):
    ramp = torch.linspace(0, 1, steps, dtype=torch.float64)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return torch.cat([s, torch.zeros(1, dtype=torch.float64)]).float()


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(torch, fn, iters: int):
    """Mean device time per call in µs, summed and by kernel name: the GPU
    kernels ``fn`` launches, from torch.profiler (None if it saw none).

    The profiler misses the first launches after it starts (eight of them,
    late in this script), so a few untimed calls run inside it first and
    only the kernels that start after them count; their number must be a
    multiple of ``iters``. ``device_us.launched`` is that number per call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(min(iters, 10)):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.004)  # the device idles: the timed kernels start well after
            with record_function("device_us_timed"):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        marks = [e.time_range.start for e in events if e.name == "device_us_timed"]
        if not marks:
            return None, {}
        t0 = min(marks) - 2000.0  # µs: inside the idle gap
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != "device_us_timed" and e.time_range.start >= t0]
        if not kernels:
            return None, {}
        if len(kernels) % iters == 0:
            break
    else:
        fail(f"device_us: the profiler saw {len(kernels)} kernels for {iters} calls")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    device_us.launched = len(kernels) / iters
    return (sum(by_name.values()) / iters,
            {k: v / iters for k, v in by_name.items()})


def fmt_us(v):
    return "not measured" if v is None else f"{v:.2f} us"


# -- the least time the card could take -------------------------------------
#
# The larger of (bytes moved: every input read once, every output written
# once) / 3.35 TB/s and (arithmetic operations the function needs on these
# inputs) / 33.5 T/s. The published fp32 peak, 67 TFLOP/s, is 33.5 T fused
# multiply-adds a second; an add, a min or an integer multiply fills the same
# dispatch slot, so every arithmetic operation counts as one (a lower bound:
# the card has half as many int32 lanes). A sparse product counts its
# nonzeros. One Philox4x32-10 call is 10 rounds of 2 mul.lo, 2 mul.hi, 4 xor,
# 2 add = 100 operations for four values; Box-Muller is a log, a sqrt, a
# cos, a sin, four multiplies and four conversions for two normals.

PHILOX_INSTR = 25  # per 32-bit value
NORMAL_INSTR = PHILOX_INSTR + 6  # per normal
B1_INSTR, B2_INSTR = 27, 7  # per element, from the plain versions' operations


def bound(nbytes: float, instr: float) -> dict:
    tb, ti = nbytes / HBM_BYTES_S, instr / INSTR_S
    return {"bytes": nbytes, "instr": instr, "us": max(tb, ti) * 1e6,
            "by": "bytes" if tb >= ti else "operations"}


def b1_bound(n: int, itemsize: int = 4) -> dict:
    return bound(6 * itemsize * n + 40, B1_INSTR * n)  # 4 inputs, 2 outputs, the scalars


def b2_bound(n: int, itemsize: int = 4) -> dict:
    return bound(2 * itemsize * n, B2_INSTR * n)


def b3_bound(n: int) -> dict:
    return bound(4 * n, NORMAL_INSTR * n)


def b4_bound(shape, ladder, mode: str, *, gen: bool) -> dict:
    """B4 on ``ladder`` (level 0 the base): the output, the small levels,
    the tap tables and a given base; per pixel the base pair (two normals
    and their sum) when drawn in-kernel, and per level th*tw + tw fused
    multiply-adds, the discount's multiply and the add."""
    from sonar_tpu_torch.ops.resample import _resize_taps

    (b, c, h, w), bc = shape, shape[0] * shape[1]
    px = bc * h * w
    nbytes, instr = 4 * px * (1 if gen else 2), px * (2 * NORMAL_INSTR + 2 if gen else 0)
    for sh, sw in ladder[1:]:
        th = _resize_taps(sh, h, mode)[0].shape[1]
        tw = _resize_taps(sw, w, mode)[0].shape[1]
        nbytes += 4 * bc * sh * sw + 8 * (h * th + w * tw)
        instr += px * (th * tw + tw + 2)
    return bound(nbytes, instr)


def b5_bound(P, shape, sizes, coefs, mode: str, *, base: bool) -> dict:
    """B5 with fields drawn in-kernel: the output and a given base; per
    pixel and level one normal and a multiply-add, or four normals, the two
    weight pairs (10) and the 2x2 blend (9) for bilinear."""
    (b, c, h, w), px = shape, shape[0] * shape[1] * shape[2] * shape[3]
    instr = 0
    for planes, *_ in P._down_levels(sizes, coefs, h, w, mode):
        instr += px * (NORMAL_INSTR + 2 if planes == 1 else 4 * NORMAL_INSTR + 19)
    return bound(4 * px * (2 if base else 1), instr)


def b6_bound(shape, n_pts: int, k: int) -> dict:
    """B6: the points read and k floats a pixel written; per (pixel, point)
    the two adds of the separable distance and the 2k min/max of the
    insertion; per (row or column, point) a wrap and its term (~10); k
    roots a pixel at most."""
    b, c, h, w = shape
    px = b * c * h * w
    return bound(4 * (3 * b * c * n_pts + h + w + k * px),
                 px * n_pts * (2 + 2 * k) + b * c * (h + w) * n_pts * 10 + px * k)


@contextlib.contextmanager
def patched(module, **attrs):
    """Swap module attributes for the block (plain versions, composed paths)."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import sonar_tpu_torch.core.normalize as N
    import sonar_tpu_torch.kernels.fused as F
    import sonar_tpu_torch.kernels.fused_pyramid as P
    import sonar_tpu_torch.kernels.voronoi as V
    import sonar_tpu_torch.noise.generators as G
    import sonar_tpu_torch.noise.voronoi as VN
    from sonar_tpu_torch.core.rng import derive_seed, seed_from
    from sonar_tpu_torch.kernels import _build
    from sonar_tpu_torch.kernels import hwrng as H
    from sonar_tpu_torch.models import UNetConfig, init_unet_params, make_denoiser
    from sonar_tpu_torch.noise import (NoiseChain, NoiseCtx, VoronoiGenerator,
                                       get_noise_item, make_noise_sampler)
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral
    from sonar_tpu_torch.samplers.momentum import SonarConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    counters = {"B1": [F.fused_momentum_step], "B2": [F.fused_scale_noise],
                "B3": [H.philox_randn, H.philox_rand],
                "B4": [P.fused_pyramid, P.fused_pyramid_accumulate],
                "B5": [P.fused_downscale_pyramid, P.fused_downscale_accumulate],
                "B6": [V.voronoi_ksmallest]}

    def reset_counts():
        for fns in counters.values():
            for f in fns:
                f.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: sum(f.launches for f in fns) for k, fns in counters.items()}

    def plain_versions():
        """The generators and scale_noise on their plain versions (on the card)."""
        stack = contextlib.ExitStack()
        stack.enter_context(patched(
            G, philox_randn=H.philox_randn_reference, philox_rand=H.philox_rand_reference,
            fused_pyramid=P.fused_pyramid_reference,
            fused_downscale_pyramid=P.fused_downscale_pyramid_reference))
        stack.enter_context(patched(N, fused_scale_noise=F.fused_scale_noise_reference))
        stack.enter_context(patched(VN, philox_rand=H.philox_rand_reference,
                                    voronoi_ksmallest=V.voronoi_ksmallest_reference))
        return stack

    def composed_path():
        """The generators with the kernel gates closed: Philox levels through
        scale_samples, the oversized levels built."""
        never = lambda *a: False  # noqa: E731
        return patched(G, fused_pyramid_supported=never, fused_downscale_supported=never)

    # -- phase 1: card, versions, build ---------------------------------------
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}")
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[1] kernels: {_build.library_path().relative_to(ROOT)} from "
          f"{[s for s in _build.SOURCES if s.endswith('.cu')]} "
          f"({'found built' if prebuilt else 'built'} in {build_s:.2f} s)")
    log = (_build.library_path().parent / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[1] ptxas: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- phase 2: B1 against its plain version --------------------------------
    b1_err = 0.0
    gates = [(h, i, w, 0.5) for h in (0.0, 1.0) for i in (0.0, 1.0) for w in (0.0, 1.0)]
    gates.append((1.0, 1.0, 1.0, 0.0))
    for shape in B1_SHAPES:
        x, den, hd, noise = (randn(shape) for _ in range(4))
        for has, inw, hw, ns in gates:
            scal = F.pack_momentum_scalars(
                sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75, hd_scale=1.05,
                md_scale=1.0, has=has, noise_scale=ns, in_window=inw,
                hist_window=hw, device=dev)
            out = F.fused_momentum_step(x, den, hd, noise, scal)
            ref = F.fused_momentum_step_reference(x, den, hd, noise, scal)
            torch.cuda.synchronize()
            for o, r, what in zip(out, ref, ("x", "hd")):
                need(o.is_cuda and o.shape == x.shape, f"B1 {what} output malformed")
                err, rel = rel_err(o, r)
                b1_err = max(b1_err, err)
                need(rel <= B1_TOL, f"B1 {shape} gates={(has, inw, hw, ns)} {what}: "
                                    f"rel err {rel:.3e} > {B1_TOL}")
    # a view that is not 16-byte aligned takes the scalar path
    flat = [randn((1 + 4 * 64 * 64,)) for _ in range(4)]
    views = [t[1:].view(SHAPE) for t in flat]
    scal = F.pack_momentum_scalars(sigma=3.0, dt=-1.0, momentum=0.9, hd_ratio=0.75,
                                   hd_scale=1.0, md_scale=1.0, has=1.0, noise_scale=0.3,
                                   device=dev)
    for o, r in zip(F.fused_momentum_step(*views, scal),
                    F.fused_momentum_step_reference(*views, scal)):
        err, rel = rel_err(o, r)
        b1_err = max(b1_err, err)
        need(rel <= B1_TOL, f"B1 unaligned: rel err {rel:.3e}")
    print(f"[2] B1 fused_momentum_step vs plain: shapes {B1_SHAPES} + unaligned, "
          f"{len(gates)} gate/noise cases each: max abs err {b1_err:.3e} "
          f"(tolerance {B1_TOL:g} x max(1,|plain|))")

    # -- phase 3: B2 against its plain version --------------------------------
    b2_err = 0.0
    for shape in B2_SHAPES:
        base = randn(shape)
        std_normal = ((base.double() - base.double().mean()) / base.double().std()).float()
        cases = {
            "standard": (std_normal, 1.0),
            "shifted_mean": (base + 0.5, 1.0),
            "scaled_std": (base * 3.0, 1.0),
            "shift_and_scale": (base * 3.0 - 1.0, 1.0),
            "zeros": (torch.zeros(shape, device=dev), 1.0),
            "factor": (base * 2.0 + 0.25, 1.7),
        }
        for case, (x, factor) in cases.items():
            out = F.fused_scale_noise(x, factor)
            ref = F.fused_scale_noise_reference(x, factor)
            again = F.fused_scale_noise(x, factor)
            torch.cuda.synchronize()
            need(out.is_cuda and out.shape == x.shape, "B2 output malformed")
            need(bool(torch.isfinite(out).all()), f"B2 {shape} {case}: non-finite output")
            err, rel = rel_err(out, ref)
            b2_err = max(b2_err, err)
            need(rel <= B2_TOL, f"B2 {shape} {case}: rel err {rel:.3e} > {B2_TOL}")
            need(torch.equal(out, again), f"B2 {shape} {case}: two runs differ")
            if case in ("standard", "zeros"):
                need(torch.equal(out, x), f"B2 {shape} {case}: should pass through as is")
        print(f"[3] B2 fused_scale_noise {shape} ({base.numel()} elements): "
              f"{len(cases)} branch cases agree, bitwise equal across runs")
    print(f"[3] B2 fused_scale_noise vs plain: max abs err {b2_err:.3e} "
          f"(tolerance {B2_TOL:g} x max(1,|plain|))")

    # -- phase 4: the main path ------------------------------------------------
    cfg = UNetConfig()
    model = init_unet_params(torch.Generator().manual_seed(0), cfg, device=dev)
    denoiser = make_denoiser(model)
    sigmas = bench_sigmas(torch)
    x0 = (torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
          * float(sigmas[0])).to(dev)

    def headline(**kw):
        return sample_sonar_euler_ancestral(denoiser, x0, sigmas, seed=7, **kw)

    reset_counts()
    out = headline()
    launches = read_counts()
    need(out.is_cuda and out.shape == SHAPE and out.dtype == torch.float32,
         f"headline output malformed: {out.shape} {out.dtype} {out.device}")
    need(bool(torch.isfinite(out).all()), "headline output is not finite")
    std = float(out.std())
    # the random UNet's epsilon is small (its output conv is scaled by 1e-2),
    # so the latent keeps roughly its starting scale sigma_0 = 14.6
    need(1.0 < std < 100.0, f"headline output std {std} implausible")
    print(f"[4] headline: UNetConfig() {SHAPE}, {STEPS} steps, seed 7: output std "
          f"{std:.4f}, mean {float(out.mean()):.4f}; launches {launches}")
    need(launches == {"B1": STEPS, "B2": STEPS, "B3": STEPS, "B4": 0, "B5": 0, "B6": 0},
         f"expected {STEPS} launches of B1, B2 and B3, got {launches}")
    repeat = headline()
    need(torch.equal(out, repeat), "headline is not reproducible for one seed")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[4] TF32 off for the comparison (cudnn.allow_tf32=False, "
          "cuda.matmul.allow_tf32=False)")
    raw = [randn(SHAPE) * 1.3 + 0.2 for _ in range(STEPS)]
    kern = sample_sonar_euler_ancestral(
        denoiser, x0, sigmas, use_fused=None,
        noise_sampler=lambda i, s, sn: F.fused_scale_noise(raw[i]))
    plain = sample_sonar_euler_ancestral(
        denoiser, x0, sigmas, use_fused=False,
        noise_sampler=lambda i, s, sn: F.fused_scale_noise_reference(raw[i]))
    torch.cuda.synchronize()
    need(bool(torch.isfinite(kern).all()) and bool(torch.isfinite(plain).all()),
         "trajectory comparison: non-finite output")
    err, rel = rel_err(kern, plain)
    print(f"[4] kernel path vs plain path on one injected stream: max abs diff "
          f"{err:.3e}, max rel diff {rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"kernel and plain trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 5: timing ---------------------------------------------------------
    print(f"[5] timing on {card} with torch defaults (cudnn TF32 on, matmul TF32 off)")
    runs = {"kernel": lambda: headline(), "plain": lambda: headline(use_fused=False)}
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    ms = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        ms[which].append(cuda_ms(torch, runs[which], 3))
    sps = {k: STEPS / (sum(v) / len(v) / 1000.0) for k, v in ms.items()}
    print(f"[5] headline steps/s: kernel path {sps['kernel']:.2f} "
          f"(runs {[round(v, 3) for v in ms['kernel']]} ms), use_fused=False "
          f"{sps['plain']:.2f} (runs {[round(v, 3) for v in ms['plain']]} ms) [{card}]")

    x, den, hd, noise = (randn(SHAPE) for _ in range(4))
    scal = F.pack_momentum_scalars(sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75,
                                   hd_scale=1.05, md_scale=1.0, has=1.0,
                                   noise_scale=0.5, device=dev)
    draw = randn(SHAPE) * 1.3 + 0.2
    timing = {
        "B1": (cuda_ms(torch, lambda: F.fused_momentum_step(x, den, hd, noise, scal), 500),
               cuda_ms(torch, lambda: F.fused_momentum_step_reference(x, den, hd, noise,
                                                                      scal), 500)),
        "B2": (cuda_ms(torch, lambda: F.fused_scale_noise(draw), 500),
               cuda_ms(torch, lambda: F.fused_scale_noise_reference(draw), 500)),
    }
    for k, (km, pm) in timing.items():
        print(f"[5] {k} at {SHAPE}: kernel {km * 1000:.2f} us/call, plain "
              f"{pm * 1000:.2f} us/call (CUDA events over back-to-back calls, "
              f"host launch cost included) [{card}]")
    fns = {"B1": (lambda: F.fused_momentum_step(x, den, hd, noise, scal),
                  lambda: F.fused_momentum_step_reference(x, den, hd, noise, scal)),
           "B2": (lambda: F.fused_scale_noise(draw),
                  lambda: F.fused_scale_noise_reference(draw))}
    dev_timing = {}  # device µs per call at the path's shape: (kernel, plain)
    for k, (kf, pf) in fns.items():
        kd, pd = device_us(torch, kf, 50)[0], device_us(torch, pf, 50)[0]
        dev_timing[k] = (kd, pd)
        print(f"[5] {k} at {SHAPE}: device time per call (torch.profiler, summed "
              f"kernels): kernel {fmt_us(kd)}, plain {fmt_us(pd)} [{card}]")
    big = [randn((4, 4, 128, 128)) for _ in range(4)]
    b1_big = cuda_ms(torch, lambda: F.fused_momentum_step(*big, scal), 200)
    gbs = 24 * big[0].numel() / (b1_big / 1000) / 1e9
    large = randn(B2_SHAPES[-1]) * 1.3 + 0.2
    b2_big = cuda_ms(torch, lambda: F.fused_scale_noise(large), 20)
    b2_plain_big = cuda_ms(torch, lambda: F.fused_scale_noise_reference(large), 20)
    bd1, bd2 = b1_bound(big[0].numel()), b2_bound(large.numel())
    print(f"[5] B1 at (4, 4, 128, 128): {b1_big * 1000:.2f} us/call, "
          f"{gbs:.0f} GB/s at 24 B/element (bound {bd1['us']:.2f} us by {bd1['by']}) "
          f"[{card}]")
    print(f"[5] B2 at {B2_SHAPES[-1]}: kernel {b2_big * 1000:.1f} us/call "
          f"({16 * large.numel() / (b2_big / 1000) / 1e9:.0f} GB/s at 16 B/element; bound "
          f"{bd2['us']:.2f} us by {bd2['by']}), plain {b2_plain_big * 1000:.1f} us/call "
          f"[{card}]")
    del big, large

    # -- phase 6: B3 against its plain version --------------------------------
    b3_err = 0.0
    for shape in B3_SHAPES:
        firsts = []
        for seed, stream in B3_SEEDS:
            u = H.philox_rand(seed, shape, device=dev, stream=stream)
            ur = H.philox_rand_reference(seed, shape, device=dev, stream=stream)
            z = H.philox_randn(seed, shape, device=dev, stream=stream)
            zr = H.philox_randn_reference(seed, shape, device=dev, stream=stream)
            again = H.philox_randn(seed, shape, device=dev, stream=stream)
            torch.cuda.synchronize()
            need(z.shape == shape and z.dtype == torch.float32 and z.is_cuda,
                 "B3 output malformed")
            need(torch.equal(u, ur), f"B3 {shape} seed {seed}: uniforms not bitwise equal")
            need(bool(((u >= 0) & (u < 1)).all()), f"B3 {shape}: uniform out of [0, 1)")
            err = float((z - zr).abs().max())
            b3_err = max(b3_err, err)
            need(err <= B3_TOL, f"B3 {shape} seed {seed}: normals differ by {err:.3e}")
            need(torch.equal(z, again), f"B3 {shape} seed {seed}: two calls differ")
            firsts.append(z)
        need(all(not torch.equal(a, b) for i, a in enumerate(firsts) for b in firsts[i + 1:]),
             f"B3 {shape}: two seeds gave equal draws")
        print(f"[6] B3 philox {shape} ({firsts[0].numel()} elements), seeds "
              f"{B3_SEEDS}: uniforms bitwise equal, normals agree, calls repeat")
    z = firsts[0].double()
    mean, sd = float(z.mean()), float(z.std())
    kurt = float(((z - z.mean()) ** 4).mean() / z.var() ** 2)
    print(f"[6] B3 moments of {z.numel()} draws: mean {mean:.2e}, std {sd:.6f}, "
          f"kurtosis {kurt:.5f}")
    need(abs(mean) < 1e-3 and abs(sd - 1) < 1e-3 and abs(kurt - 3) < 1e-2,
         "B3 moments off")
    print(f"[6] B3 philox_randn vs plain: max abs err {b3_err:.3e} (tolerance "
          f"{B3_TOL:g} absolute)")
    del z, firsts, u, ur, zr, again

    # -- phase 7: B4 against its plain version --------------------------------
    b4_err = 0.0
    for hw in PYR_HW:
        sizes = G._size_ladder_pyramid(*hw, 10, 0)
        shape = (1, 4, *hw)
        disc = [0.7**i for i in range(1, len(sizes))]
        base = randn((4, *hw))
        smalls = [randn((4, sh, sw)) for sh, sw in sizes[1:]]
        for mode in P.UP_MODES:
            for what, out, ref in (
                    ("gen_base", P.fused_pyramid(11, shape, sizes, 0.7, mode, device=dev),
                     P.fused_pyramid_reference(11, shape, sizes, 0.7, mode, device=dev)),
                    ("given base", P.fused_pyramid_accumulate(base, smalls, disc, mode),
                     P.fused_pyramid_accumulate_reference(base, smalls, disc, mode))):
                torch.cuda.synchronize()
                need(bool(torch.isfinite(out).all()), f"B4 {hw} {mode}: non-finite")
                err, rel = rel_err(out, ref)
                b4_err = max(b4_err, err)
                need(rel <= PYR_TOL, f"B4 {hw} {mode} {what}: rel err {rel:.3e}")
        print(f"[7] B4 pyramid {hw} ladder {sizes}: {len(P.UP_MODES)} modes, in-kernel "
              f"and given base agree")
    for hw, below in PYR_EDGE:
        sizes = [hw, *below]
        for bc in (1, 3):
            shape = (1, bc, *hw)
            disc = [0.7**i for i in range(1, len(sizes))]
            base = randn((bc, *hw))
            smalls = [randn((bc, sh, sw)) for sh, sw in below]
            for mode in P.UP_MODES:
                for what, out, ref in (
                        ("gen_base", P.fused_pyramid(17, shape, sizes, 0.7, mode, device=dev),
                         P.fused_pyramid_reference(17, shape, sizes, 0.7, mode, device=dev)),
                        ("given base", P.fused_pyramid_accumulate(base, smalls, disc, mode),
                         P.fused_pyramid_accumulate_reference(base, smalls, disc, mode))):
                    torch.cuda.synchronize()
                    need(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                         f"B4 {hw} {mode}: malformed or non-finite")
                    err, rel = rel_err(out, ref)
                    b4_err = max(b4_err, err)
                    need(rel <= PYR_TOL, f"B4 edge {sizes} bc={bc} {mode} {what}: rel err "
                                         f"{rel:.3e}")
    print(f"[7] B4 edge ladders {[(hw, len(b)) for hw, b in PYR_EDGE]} (size, levels), 1 and "
          f"3 planes, {len(P.UP_MODES)} modes, in-kernel and given base agree")
    print(f"[7] B4 fused_pyramid vs plain: max abs err {b4_err:.3e} (tolerance "
          f"{PYR_TOL:g} x max(1,|plain|), matmul TF32 off)")

    # -- phase 8: B5 against its plain version --------------------------------
    b5_err, skipped = 0.0, []
    for hw in DOWN_HW:
        shape = (1, 4, *hw)
        hi = G._size_ladder_highres(*hw, 4, 0)
        ladders = {
            "highres_pyramid": (hi, [0.7**i for i in range(len(hi))]),
            "pyramid_old": ([(hw[0] * 2 ** (i + 1), hw[1] * 2 ** (i + 1)) for i in range(5)],
                            [(0.5**i) * 0.8**i for i in range(5)]),
        }
        base = randn(shape)
        for lname, (sizes, coefs) in ladders.items():
            gs = [randn((4, 4, *hw)) for _ in sizes]
            for mode in P.DOWN_MODES:
                if not P.fused_downscale_supported(sizes, *hw, mode):
                    skipped.append((hw, lname, mode))
                    continue
                cases = [
                    (f"gen, base {b is not None}",
                     P.fused_downscale_pyramid(13, shape, sizes, coefs, mode, base=b,
                                               device=dev),
                     P.fused_downscale_pyramid_reference(13, shape, sizes, coefs, mode,
                                                         base=b, device=dev))
                    for b in (None, base)]
                cases.append(("given fields",
                              P.fused_downscale_accumulate(gs, hw, sizes, coefs, mode,
                                                           base=base[0]),
                              P.fused_downscale_accumulate_reference(gs, hw, sizes, coefs,
                                                                     mode, base=base[0])))
                for what, out, ref in cases:
                    torch.cuda.synchronize()
                    need(bool(torch.isfinite(out).all()), f"B5 {hw} {mode}: non-finite")
                    err, rel = rel_err(out, ref)
                    b5_err = max(b5_err, err)
                    need(rel <= PYR_TOL, f"B5 {hw} {lname} {mode} {what}: rel err {rel:.3e}")
        print(f"[8] B5 {hw}: highres ladder {hi} and the pyramid_old ladder agree")
    print(f"[8] B5 not run where the gate is closed (composed path): {skipped}")
    print(f"[8] B5 fused_downscale_pyramid vs plain: max abs err {b5_err:.3e} "
          f"(tolerance {PYR_TOL:g} x max(1,|plain|))")

    # -- phase 9: the pyramid path --------------------------------------------
    pyr_cfg = SonarConfig(noise_type="pyramid")
    ladder = G._size_ladder_pyramid(SHAPE[2], SHAPE[3], 10, 0)
    reset_counts()
    pout = headline(sonar_config=pyr_cfg)
    path_launches = read_counts()
    need(pout.is_cuda and pout.shape == SHAPE and bool(torch.isfinite(pout).all()),
         "pyramid path output malformed or not finite")
    pstd = float(pout.std())
    need(1.0 < pstd < 100.0, f"pyramid path output std {pstd} implausible")
    want = {"B1": STEPS, "B2": STEPS, "B3": STEPS * (len(ladder) - 1), "B4": STEPS, "B5": 0,
            "B6": 0}
    print(f"[9] pyramid path: UNetConfig() {SHAPE}, {STEPS} steps, seed 7, ladder "
          f"{ladder}: output std {pstd:.4f}; launches {path_launches}")
    need(path_launches == want, f"pyramid path: expected launches {want}")
    need(torch.equal(pout, headline(sonar_config=pyr_cfg)), "pyramid path not reproducible")
    need(not torch.equal(pout, out), "pyramid path equals the gaussian headline")
    short = bench_sigmas(torch, SHORT_STEPS)
    down_launches = {}
    for nt in ("highres_pyramid", "pyramid_old"):
        reset_counts()
        o = sample_sonar_euler_ancestral(denoiser, x0, short, seed=7,
                                         sonar_config=SonarConfig(noise_type=nt))
        c = down_launches[nt] = read_counts()
        need(bool(torch.isfinite(o).all()), f"{nt} path not finite")
        print(f"[9] {nt} path: {SHORT_STEPS} steps, output std {float(o.std()):.4f}; "
              f"launches {c}")
        need(c["B5"] == SHORT_STEPS and c["B1"] == SHORT_STEPS and c["B4"] == 0,
             f"{nt}: expected {SHORT_STEPS} launches of B5 and B1, got {c}")

    for nt in ("gaussian", "pyramid", "highres_pyramid", "pyramid_old"):
        kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
        cfn, cst = make_noise_sampler(get_noise_item(nt), SHAPE, device="cpu", **kw)
        gfn, gst = make_noise_sampler(get_noise_item(nt), SHAPE, device=dev, **kw)
        worst = 0.0
        for _ in range(3):
            a, cst = cfn(cst, 1.0, 0.9)
            b, gst = gfn(gst, 1.0, 0.9)
            need(a.device.type == "cpu" and b.is_cuda, f"{nt}: draws on the wrong device")
            _, rel = rel_err(b, a)
            worst = max(worst, rel)
        print(f"[9] {nt}: seed 1234, 3 draws, CPU (plain) vs card (kernels): max rel "
              f"diff {worst:.3e} (tolerance {XDEV_TOL:g})")
        need(worst <= XDEV_TOL, f"{nt}: CPU and card streams differ ({worst:.3e})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with plain_versions():
        nfn, nst = make_noise_sampler(
            get_noise_item("pyramid"), SHAPE, dtype=torch.float32, device=dev,
            sigma_min=float(sigmas[sigmas > 0].min()), sigma_max=float(sigmas.max()),
            seed=derive_seed(seed_from(7), "noise"), normalized=True, ref_latent=x0)
        sl = sigmas.tolist()
        pdraws = []
        for i in range(STEPS):
            d, nst = nfn(nst, sl[i], sl[i + 1])
            pdraws.append(d)
    kern = headline(sonar_config=pyr_cfg)
    plain = sample_sonar_euler_ancestral(denoiser, x0, sigmas, use_fused=False,
                                         noise_sampler=lambda i, s, sn: pdraws[i])
    torch.cuda.synchronize()
    err, rel = rel_err(kern, plain)
    print(f"[9] pyramid path (kernels) vs the sampler fed the plain versions' draws "
          f"(plain momentum step), TF32 off: max abs diff {err:.3e}, max rel diff "
          f"{rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"pyramid trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- phase 10: timing -------------------------------------------------------
    print(f"[10] timing on {card} (cudnn TF32 on, matmul TF32 off)")
    runs = {"gaussian": lambda: headline(), "pyramid": lambda: headline(sonar_config=pyr_cfg)}
    ms = {"gaussian": [], "pyramid": []}
    for which in ("gaussian", "pyramid", "pyramid", "gaussian"):
        ms[which].append(cuda_ms(torch, runs[which], 3))
    sps = {k: STEPS / (sum(v) / len(v) / 1000.0) for k, v in ms.items()}
    print(f"[10] steps/s: pyramid path {sps['pyramid']:.2f} (runs "
          f"{[round(v, 3) for v in ms['pyramid']]} ms), gaussian headline "
          f"{sps['gaussian']:.2f} (runs {[round(v, 3) for v in ms['gaussian']]} ms) [{card}]")

    def draws(nt, shape, iters):
        fn, st = make_noise_sampler(get_noise_item(nt), shape, device=dev, seed=3,
                                    sigma_min=0.03, sigma_max=14.6)

        def run():
            s = st
            for _ in range(iters):
                _, s = fn(s, 1.0, 0.9)

        return run

    mshape, miters = (1, 4, 128, 128), 50
    mpix = {}
    for which in ("kernel", "composed", "composed", "kernel"):
        with composed_path() if which == "composed" else contextlib.nullcontext():
            t = cuda_ms(torch, draws("pyramid", mshape, miters), 3)
        mpix.setdefault(which, []).append(65536 * miters / (t / 1000) / 1e6)
    print(f"[10] pyramid noise at {mshape}, {miters} draws (normalized): kernel path "
          f"{[round(v, 1) for v in mpix['kernel']]} Mpix/s, composed path "
          f"{[round(v, 1) for v in mpix['composed']]} Mpix/s [{card}]")

    def generate(nt, shape):
        g, ctx = get_noise_item(nt), NoiseCtx(shape=shape, device=dev)
        st = g.init_state(ctx, 1)
        return lambda: g.generate(ctx, st, 99, 1.0, 0.9)

    def composed(fn):
        def run():
            with composed_path():
                fn()
        return run

    bshape = (4, 4, 512, 512)
    blad = G._size_ladder_pyramid(512, 512, 10, 0)
    b4 = {"kernel": cuda_ms(torch, lambda: P.fused_pyramid(5, bshape, blad, 0.7,
                                                           device=dev), 20),
          "plain": cuda_ms(torch, lambda: P.fused_pyramid_reference(5, bshape, blad, 0.7,
                                                                    device=dev), 20),
          "composed": cuda_ms(torch, composed(generate("pyramid", bshape)), 20)}
    print(f"[10] pyramid draw at {bshape} (B3 small levels + B4): kernel "
          f"{b4['kernel'] * 1000:.1f} us, plain {b4['plain'] * 1000:.1f} us, composed "
          f"path {b4['composed'] * 1000:.1f} us per draw [{card}]")
    # B4 alone on the device beside the composed path (Philox levels through
    # scale_samples' dense products), in turns, at the large shape and the path's
    def b4_device(shape, lad, iters):
        kf = lambda: P.fused_pyramid(5, shape, lad, 0.7, device=dev)  # noqa: E731
        cf = composed(generate("pyramid", shape))
        got = {"B4": [], "B3": [], "composed": []}
        for which in ("kernel", "composed", "composed", "kernel"):
            if which == "kernel":
                _, by = device_us(torch, kf, iters)
                got["B4"].append(sum(v for k, v in by.items() if "pyramid_up_kernel" in k))
                got["B3"].append(sum(v for k, v in by.items() if "philox_fill_kernel" in k))
            else:
                got["composed"].append(device_us(torch, cf, iters)[0])
        return got

    b4_dev = {}
    for shape, lad, iters in ((bshape, blad, 10), (SHAPE, ladder, 50)):
        got = b4_dev[shape] = b4_device(shape, lad, iters)
        bound = b4_bound(shape, lad, "bilinear", gen=True)
        need(all(got["B4"]) and all(got["composed"]), "B4: device time not measured")
        print(f"[10] pyramid draw at {shape}, ladder {lad}, device time per draw: B4 alone "
              f"{[round(v, 2) for v in got['B4']]} us (bound {bound['us']:.2f} us by "
              f"{bound['by']}: {bound['bytes'] / 1e6:.3f} MB, {bound['instr'] / 1e6:.2f} M "
              f"operations), {len(lad) - 1} B3 launches {[round(v, 2) for v in got['B3']]} "
              f"us; composed path {[round(v, 2) for v in got['composed']]} us [{card}]")
    dshape = (1, 4, 128, 128)
    dbase = randn(dshape)
    hl = G._size_ladder_highres(128, 128, 4, 0)
    old = [(128 * 2 ** (i + 1),) * 2 for i in range(5)]
    b5_cases = {
        "pyramid_old": (old, [(0.5**i) * 0.8**i for i in range(5)], "nearest-exact", None),
        "highres_pyramid": (hl, [0.7**i for i in range(len(hl))], "bilinear", dbase),
    }
    for nt, (sz, cf, mode, b) in b5_cases.items():
        k = cuda_ms(torch, lambda: P.fused_downscale_pyramid(5, dshape, sz, cf, mode, base=b,
                                                             device=dev), 50)
        p = cuda_ms(torch, lambda: P.fused_downscale_pyramid_reference(
            5, dshape, sz, cf, mode, base=b, device=dev), 50)
        c = cuda_ms(torch, composed(generate(nt, dshape)), 5)
        print(f"[10] B5 {nt} at {dshape}, ladder {sz}: kernel {k * 1000:.1f} us, plain "
              f"{p * 1000:.1f} us, composed path (oversized levels built) "
              f"{c * 1000:.1f} us per draw [{card}]")
    lshape = B3_SHAPES[-1]
    b3 = {"kernel": cuda_ms(torch, lambda: H.philox_randn(5, lshape, device=dev), 20),
          "plain": cuda_ms(torch, lambda: H.philox_randn_reference(5, lshape, device=dev), 20),
          "torch.randn": cuda_ms(torch, lambda: torch.randn(lshape, device=dev), 20)}
    n = 1
    for d in lshape:
        n *= d
    bd3 = b3_bound(n)
    print(f"[10] B3 at {lshape} ({n} elements): kernel {b3['kernel'] * 1000:.1f} us "
          f"({4 * n / (b3['kernel'] / 1000) / 1e9:.0f} GB/s written; bound "
          f"{bd3['us']:.2f} us by {bd3['by']}), plain "
          f"{b3['plain'] * 1000:.1f} us, torch.randn {b3['torch.randn'] * 1000:.1f} us "
          f"[{card}]")

    # the path's calls at its shape: events (host cost included) and device time
    hl64 = G._size_ladder_highres(*SHAPE[2:], 4, 0)
    hc64 = [0.7**i for i in range(len(hl64))]
    pbase = randn(SHAPE)
    path_fns = {
        "B3": (lambda: H.philox_randn(5, SHAPE, device=dev),
               lambda: H.philox_randn_reference(5, SHAPE, device=dev)),
        "B4": (lambda: P.fused_pyramid(5, SHAPE, ladder, 0.7, device=dev),
               lambda: P.fused_pyramid_reference(5, SHAPE, ladder, 0.7, device=dev)),
        "B5": (lambda: P.fused_downscale_pyramid(5, SHAPE, hl64, hc64, base=pbase,
                                                 device=dev),
               lambda: P.fused_downscale_pyramid_reference(5, SHAPE, hl64, hc64,
                                                           base=pbase, device=dev)),
    }
    for k, (kf, pf) in path_fns.items():
        timing[k] = (cuda_ms(torch, kf, 200), cuda_ms(torch, pf, 200))
        (kd, kby), (pd, _) = device_us(torch, kf, 50), device_us(torch, pf, 50)
        # B4's draw also launches B3 for the small levels: B4 is its own kernel's time
        dev_timing[k] = (sum(v for n_, v in kby.items() if "pyramid_up_kernel" in n_)
                         if k == "B4" else kd, pd)
        by = ", ".join(f"{n_}: {v:.2f} us" for n_, v in sorted(kby.items()))
        print(f"[10] {k} at {SHAPE} as the path calls it: kernel "
              f"{timing[k][0] * 1000:.2f} us/call, plain {timing[k][1] * 1000:.2f} "
              f"us/call (events, host cost included); device time kernel {fmt_us(kd)} "
              f"({by}), plain {fmt_us(pd)} [{card}]")

    library_us = {"B3": device_us(torch, lambda: torch.randn(SHAPE, device=dev), 50)[0],
                  "B4": sum(b4_dev[SHAPE]["composed"]) / 2}
    print(f"[10] PyTorch routes for the same functions at {SHAPE}, device time: torch.randn "
          f"{fmt_us(library_us['B3'])} (B3), the composed pyramid draw "
          f"{fmt_us(library_us['B4'])} (B4) [{card}]")

    # -- phase 11: B6 against its plain version -------------------------------
    b6_err, b6_cases = 0.0, 0
    dists = [("euclidean", 3.0), ("quadratic", 3.0), ("chebyshev", 3.0), ("minkowski", 2.5)]

    def b6_case(fp, ys, xs, z, what, **kw):
        nonlocal b6_err, b6_cases
        o = V.voronoi_ksmallest(fp, ys, xs, z, **kw)
        r = V.voronoi_ksmallest_reference(fp, ys, xs, z, **kw)
        torch.cuda.synchronize()
        need(o.is_cuda and o.shape == r.shape and o.dtype == torch.float32,
             "B6 output malformed")
        err, rel = rel_err(o, r)
        b6_err = max(b6_err, err)
        b6_cases += 1
        if kw["dist"] == "minkowski":
            need(rel <= B6_TOL, f"B6 {what} {kw}: rel err {rel:.3e}")
        else:
            need(torch.equal(o, r), f"B6 {what} {kw}: not bit-equal ({err:.3e})")

    def b6_inputs(b, c, h, w, n_pts):
        return (torch.rand((b, c, n_pts, 3), generator=gen, device=dev),
                torch.arange(h, dtype=torch.float32, device=dev) / h,
                torch.arange(w, dtype=torch.float32, device=dev) / w)

    for n_pts in B6_POINTS:
        for shape in B6_SHAPES:
            fp, ys, xs = b6_inputs(*shape, n_pts)
            z = torch.tensor(0.37, device=dev)
            for dist, p in dists:
                for k in (1, 2, 4, 8):
                    for scale, wts in ((1.0, (1.0, 1.0, 1.0)), (8.0, (2.0, 1.0, 0.25))):
                        b6_case(fp, ys, xs, z, f"N={n_pts} {shape}", scale=scale, k=k,
                                dist=dist, p=p, weights=wts)
    print(f"[11] B6 voronoi_ksmallest vs plain: {b6_cases} cases (N {B6_POINTS}, shapes "
          f"{B6_SHAPES}, 4 distances, k 1/2/4/8, plain and weighted x8): euclidean, "
          f"quadratic, chebyshev bit-equal; max abs err {b6_err:.3e} (minkowski tolerance "
          f"{B6_TOL:g} x max(1,|plain|))")
    first = b6_cases
    for n_pts in B6_TILE_POINTS:
        for shape in B6_TILE_SHAPES:
            fp, ys, xs = b6_inputs(*shape, n_pts)
            for dist, p in dists:
                for k in (1, 3, 8):
                    b6_case(fp, ys, xs, 0.37, f"N={n_pts} {shape}", scale=3.0, k=k,
                            dist=dist, p=p, weights=(1.0, 1.5, 0.5))
    # the generator's call: strided views of the grid, a 0-dim z, points outside [0, 1)
    h, w = 67, 61
    fp, ys, xs = b6_inputs(1, 3, h, w, 50)
    grid3d = torch.cat([torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1),
                        torch.tensor(0.81, device=dev).expand(h, w, 1)], dim=-1)
    for dist, p in dists:
        b6_case(fp * 3.0 - 1.0, grid3d[:, 0, 0], grid3d[0, :, 1], grid3d[0, 0, 2],
                "strided grid", scale=2.0, k=2, dist=dist, p=p, weights=(1.0, 1.0, 1.0))
    print(f"[11] B6 tiles and splits: {b6_cases - first} more cases (shapes {B6_TILE_SHAPES}: "
          f"tiles of 4, 8, 16 and 32 rows; N {B6_TILE_POINTS}, k 1/3/8 with k = N = 8; "
          f"strided grid vectors, points outside [0, 1)): same limits, max abs err "
          f"{b6_err:.3e}")

    # -- phase 12: the Voronoi path ---------------------------------------------
    vor_cfg = SonarConfig(noise_type="voronoi_mix")
    reset_counts()
    vout = headline(sonar_config=vor_cfg)
    vor_launches = read_counts()
    need(vout.is_cuda and vout.shape == SHAPE and bool(torch.isfinite(vout).all()),
         "voronoi path output malformed or not finite")
    vstd = float(vout.std())
    need(1.0 < vstd < 100.0, f"voronoi path output std {vstd} implausible")
    # per step: B1, B2 once; B6 once per octave (3); B3 three point draws
    # (reset mode, z_max 0) and the gaussian member; three point draws at set-up
    want = {"B1": STEPS, "B2": STEPS, "B3": 4 * STEPS + 3, "B4": 0, "B5": 0, "B6": 3 * STEPS}
    print(f"[12] voronoi_mix path: UNetConfig() {SHAPE}, {STEPS} steps, seed 7: output std "
          f"{vstd:.4f}; launches {vor_launches}")
    need(vor_launches == want, f"voronoi path: expected launches {want}")
    need(torch.equal(vout, headline(sonar_config=vor_cfg)), "voronoi path not reproducible")
    need(not torch.equal(vout, out), "voronoi path equals the gaussian headline")

    chain_item = lambda: NoiseChain([VoronoiGenerator(  # noqa: E731
        1.0, n_points=(128,), octaves=2, octave_mode="new_features", result_mode=("f3",),
        distance_mode=("weight:name=euclidean:h=1.5",), z_max=3.0, z_max_mode="bounce")])
    short_cases = {
        # generic path (fuzz of angle_tanh): B3 for the points and the fuzz
        # each step, the points once at set-up; no B6
        "voronoi_fuzz": (SonarConfig(noise_type="voronoi_fuzz"),
                         {"B1": SHORT_STEPS, "B2": SHORT_STEPS, "B3": 2 * SHORT_STEPS + 1,
                          "B4": 0, "B5": 0, "B6": 0}),
        # bounce mode draws points only at set-up (two groups); B6 per octave
        "custom_noise": (SonarConfig(custom_noise=chain_item()),
                         {"B1": SHORT_STEPS, "B2": SHORT_STEPS, "B3": 2, "B4": 0, "B5": 0,
                          "B6": 2 * SHORT_STEPS}),
    }
    for nt, (c, want) in short_cases.items():
        reset_counts()
        o = sample_sonar_euler_ancestral(denoiser, x0, short, seed=7, sonar_config=c)
        got = read_counts()
        need(bool(torch.isfinite(o).all()), f"{nt} path not finite")
        print(f"[12] {nt} path: {SHORT_STEPS} steps, output std {float(o.std()):.4f}; "
              f"launches {got}")
        need(got == want, f"{nt}: expected launches {want}")
        need(torch.equal(o, sample_sonar_euler_ancestral(denoiser, x0, short, seed=7,
                                                         sonar_config=c)),
             f"{nt} path not reproducible")

    xdev_items = {"voronoi_mix": lambda: get_noise_item("voronoi_mix"),
                  "voronoi_fuzz": lambda: get_noise_item("voronoi_fuzz"),
                  "custom_noise": chain_item}
    for nt, make in xdev_items.items():
        kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
        cfn, cst = make_noise_sampler(make(), SHAPE, device="cpu", **kw)
        gfn, gst = make_noise_sampler(make(), SHAPE, device=dev, **kw)
        worst = 0.0
        for _ in range(3):
            a, cst = cfn(cst, 1.0, 0.9)
            b, gst = gfn(gst, 1.0, 0.9)
            need(a.device.type == "cpu" and b.is_cuda, f"{nt}: draws on the wrong device")
            _, rel = rel_err(b, a)
            worst = max(worst, rel)
        print(f"[12] {nt}: seed 1234, 3 draws, CPU (plain) vs card (kernels): max rel diff "
              f"{worst:.3e} (tolerance {XDEV_TOL:g})")
        need(worst <= XDEV_TOL, f"{nt}: CPU and card streams differ ({worst:.3e})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with plain_versions():
        nfn, nst = make_noise_sampler(
            get_noise_item("voronoi_mix"), SHAPE, dtype=torch.float32, device=dev,
            sigma_min=float(sigmas[sigmas > 0].min()), sigma_max=float(sigmas.max()),
            seed=derive_seed(seed_from(7), "noise"), normalized=True, ref_latent=x0)
        vdraws = []
        for i in range(STEPS):
            d, nst = nfn(nst, sl[i], sl[i + 1])
            vdraws.append(d)
    kern = headline(sonar_config=vor_cfg)
    plain = sample_sonar_euler_ancestral(denoiser, x0, sigmas, use_fused=False,
                                         noise_sampler=lambda i, s, sn: vdraws[i])
    torch.cuda.synchronize()
    err, rel = rel_err(kern, plain)
    print(f"[12] voronoi path (kernels) vs the sampler fed the plain versions' draws "
          f"(plain momentum step), TF32 off: max abs diff {err:.3e}, max rel diff "
          f"{rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"voronoi trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- phase 13: bf16 and fp16 latents through B1 and B2 ---------------------
    for dt in (torch.bfloat16, torch.float16):
        ulp, plain_tol = LOW_TOL[str(dt).split(".")[-1]]
        worst_up, worst_plain = 0.0, 0.0
        for shape in B1_SHAPES:
            ts = [randn(shape).to(dt) for _ in range(4)]
            for has, inw, hw, ns in gates:
                scal = F.pack_momentum_scalars(
                    sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75, hd_scale=1.05,
                    md_scale=1.0, has=has, noise_scale=ns, in_window=inw,
                    hist_window=hw, device=dev)
                o_k = F.fused_momentum_step(*ts, scal)
                o_u = F.fused_momentum_step_reference(*(t.float() for t in ts), scal)
                o_p = F.fused_momentum_step_reference(*ts, scal)
                for o, u, q in zip(o_k, o_u, o_p):
                    need(o.dtype == dt and o.is_cuda, f"B1 {dt}: output dtype {o.dtype}")
                    need(torch.equal(o, u.to(dt)), f"B1 {dt} {shape}: not equal to the plain "
                                                   f"version on the float32 upcast")
                    worst_plain = max(worst_plain, rel_err(o, q)[1])
            for x, factor in ((ts[0] * 3 + 0.5, 1.0), (ts[1] * 2 + 0.25, 1.7), (ts[2], 1.0)):
                x = x.to(dt)
                o = F.fused_scale_noise(x, factor)
                u = F.fused_scale_noise_reference(x.float(), factor).to(dt)
                need(o.dtype == dt and torch.equal(o, F.fused_scale_noise(x, factor)),
                     f"B2 {dt}: dtype or repeatability")
                e = float(((o.double() - u.double()).abs()
                           / u.double().abs().clamp(min=1)).max())
                worst_up = max(worst_up, e)
                need(e <= ulp, f"B2 {dt} {shape}: {e:.3e} from the float32 upcast")
                worst_plain = max(worst_plain, rel_err(o, F.fused_scale_noise_reference(
                    x, factor))[1])
        torch.cuda.synchronize()
        print(f"[13] B1/B2 on {dt}: B1 equal to the plain version on the float32 upcast; B2 "
              f"within {worst_up:.3e} of it (one ulp {ulp:g}); against the plain version "
              f"run in {dt}: {worst_plain:.3e} (tolerance {plain_tol:g}) x max(1,|plain|)")
        need(worst_plain <= plain_tol, f"{dt}: kernels and plain versions differ")

    target = (torch.arange(4 * 64 * 64, dtype=torch.float32, device=dev).reshape(SHAPE)
              / 1e3).to(torch.bfloat16)

    def stub(xb, sig, **_):
        return ((xb * 0.9 + target) / (1.0 + sig.reshape(-1, 1, 1, 1) * 0.05)).to(xb.dtype)

    xb = x0.to(torch.bfloat16)
    reset_counts()
    bout = sample_sonar_euler_ancestral(stub, xb, sigmas, seed=7)
    bf_launches = read_counts()
    need(bout.dtype == torch.bfloat16 and bout.is_cuda and bout.shape == SHAPE
         and bool(torch.isfinite(bout).all()), "bf16 headline output malformed")
    need(bf_launches == {"B1": STEPS, "B2": STEPS, "B3": STEPS, "B4": 0, "B5": 0, "B6": 0},
         f"bf16 headline launches {bf_launches}")
    bplain = sample_sonar_euler_ancestral(stub, xb, sigmas, seed=7, use_fused=False)
    berr = float((bout.double() - bplain.double()).abs().max())
    bscale = float(bplain.double().abs().max())
    print(f"[13] bf16 headline (stub denoiser, {SHAPE}, {STEPS} steps): dtype {bout.dtype}, "
          f"launches {bf_launches}; vs use_fused=False max abs diff {berr:.4f} of max "
          f"|trajectory| {bscale:.3f} (tolerance {BF16_TRAJ_TOL:g} relative)")
    need(berr <= BF16_TRAJ_TOL * bscale, "bf16 kernel and plain trajectories differ")

    # -- phase 14: timing -------------------------------------------------------
    print(f"[14] timing on {card} (cudnn TF32 on, matmul TF32 off)")
    runs = {"gaussian": lambda: headline(), "voronoi": lambda: headline(sonar_config=vor_cfg)}
    ms = {"gaussian": [], "voronoi": []}
    for which in ("gaussian", "voronoi", "voronoi", "gaussian"):
        ms[which].append(cuda_ms(torch, runs[which], 3))
    sps = {k: STEPS / (sum(v) / len(v) / 1000.0) for k, v in ms.items()}
    print(f"[14] steps/s: voronoi_mix path {sps['voronoi']:.2f} (runs "
          f"{[round(v, 3) for v in ms['voronoi']]} ms), gaussian headline "
          f"{sps['gaussian']:.2f} (runs {[round(v, 3) for v in ms['gaussian']]} ms) [{card}]")
    # where a run's device time goes, and the device's busy share of the run
    for which in ("gaussian", "voronoi"):
        tot, by = device_us(torch, runs[which], 1)
        if tot is None:
            print(f"[14] {which} run: device time not measured [{card}]")
            continue
        parts = {"B6": "voronoi_ksmallest_kernel", "B3": "philox_fill_kernel",
                 "B1": "momentum_step_kernel", "B2": "scale_noise_"}
        got = {k: sum(v for n_, v in by.items() if pat in n_) for k, pat in parts.items()}
        wall = sum(ms[which]) / len(ms[which]) * 1000
        print(f"[14] {which} run, {device_us.launched:.0f} device kernels, device time: "
              f"{tot:.1f} us of {wall:.1f} us wall "
              f"(busy {100 * tot / wall:.1f} %); {', '.join(f'{k} {v:.1f} us' for k, v in got.items())}"
              f", the rest (UNet, torch ops) {tot - sum(got.values()):.1f} us [{card}]")

    def b6_fns(shape, k, n_pts=256):
        fp = torch.rand((shape[0], shape[1], n_pts, 3), generator=gen, device=dev)
        ys = torch.arange(shape[2], dtype=torch.float32, device=dev) / shape[2]
        xs = torch.arange(shape[3], dtype=torch.float32, device=dev) / shape[3]
        z = torch.tensor(0.25, device=dev)
        return (lambda: V.voronoi_ksmallest(fp, ys, xs, z, scale=2.0, k=k),
                lambda: V.voronoi_ksmallest_reference(fp, ys, xs, z, scale=2.0, k=k))

    kf, pf = b6_fns(SHAPE, 2)
    timing["B6"] = (cuda_ms(torch, kf, 200), cuda_ms(torch, pf, 200))
    (kd, kby), (pd, _) = device_us(torch, kf, 50), device_us(torch, pf, 50)
    dev_timing["B6"] = (kd, pd)
    print(f"[14] B6 at {SHAPE}, N=256, k=2 as the path calls it: kernel "
          f"{timing['B6'][0] * 1000:.2f} us/call, plain {timing['B6'][1] * 1000:.2f} us/call "
          f"(events, host cost included); device time kernel {fmt_us(kd)} "
          f"({', '.join(f'{n_}: {v:.2f} us' for n_, v in sorted(kby.items()))}), plain "
          f"{fmt_us(pd)} [{card}]")
    for shape in (SHAPE, VORONOI_BENCH):
        px = shape[0] * shape[1] * shape[2] * shape[3]
        for k in (1, 2, 4, 8):
            kf, pf = b6_fns(shape, k)
            ke = cuda_ms(torch, kf, 100)
            (kd, kby), (pd, _) = device_us(torch, kf, 20), device_us(torch, pf, 5)
            b6k = sum(v for n_, v in kby.items() if "voronoi" in n_)
            need(b6k > 0, "B6: device time not measured")
            bd = b6_bound(shape, 256, k)
            print(f"[14] B6 at {shape}, N=256, k={k}: kernel {ke * 1000:.2f} us/call "
                  f"(events), device {fmt_us(kd)} (B6 alone {b6k:.2f} us, "
                  f"{px * 256 / (b6k * 1e-6) / 1e9:.1f} G pixel-points/s; bound "
                  f"{bd['us']:.2f} us by {bd['by']}); plain device {fmt_us(pd)} [{card}]")

    # f1 (k = 1): B6, the route the generator takes, against the per-axis path and a min
    h1, w1 = VORONOI_BENCH[2], VORONOI_BENCH[3]
    g1 = VoronoiGenerator(n_points=(256,))
    need(g1._kernel_plan(NoiseCtx(shape=VORONOI_BENCH, device=dev), 0, h1, w1)
         == ("euclidean", 3.0, None, 1.0, 1), "f1 does not plan kernel B6")
    fp1 = torch.rand((1, 4, 256, 3), generator=gen, device=dev)
    ys1 = torch.arange(h1, dtype=torch.float32, device=dev) / h1
    xs1 = torch.arange(w1, dtype=torch.float32, device=dev) / w1
    z1 = torch.tensor(0.25, device=dev)
    grid3d = torch.cat([torch.stack(torch.meshgrid(ys1, xs1, indexing="ij"), dim=-1),
                        z1.expand(h1, w1, 1)], dim=-1)
    axis_k1 = lambda: VN._sorted_small(  # noqa: E731
        g1._axis_distance(("euclidean", 3.0, None, 1.0), grid3d, fp1, 1.0), 1)
    kern_k1 = lambda: V.voronoi_ksmallest(fp1, ys1, xs1, z1, scale=1.0, k=1)  # noqa: E731
    need(torch.equal(axis_k1()[..., 0], kern_k1()[..., 0]), "k=1: per-axis path and B6 differ")
    ae, ke = cuda_ms(torch, axis_k1, 50), cuda_ms(torch, kern_k1, 50)
    ad, kd = device_us(torch, axis_k1, 10)[0], device_us(torch, kern_k1, 10)[0]
    print(f"[14] f1 (k=1) at {VORONOI_BENCH}, N=256: B6 {ke * 1000:.2f} us/call (device "
          f"{fmt_us(kd)}), per-axis path + min {ae * 1000:.2f} us/call (device "
          f"{fmt_us(ad)}); equal outputs [{card}]")

    def vdraws_run(item, iters):
        fn, st = make_noise_sampler(item, VORONOI_BENCH, device=dev, seed=5, sigma_min=0.03,
                                    sigma_max=14.6)

        def run():
            s_ = st
            for _ in range(iters):
                _, s_ = fn(s_, 1.0, 0.9)

        return run

    never = lambda *a: False  # noqa: E731
    viters = 20
    px = VORONOI_BENCH[0] * VORONOI_BENCH[2] * VORONOI_BENCH[3]
    for label, kw in (("bench (f1, 2 octaves)", {}),
                      ("diff2, 2 octaves", {"result_mode": ("diff2",)})):
        mp = {}
        for which in ("kernel", "plain", "plain", "kernel"):
            ctx = (patched(VN, voronoi_kernel_supported=never) if which == "plain"
                   else contextlib.nullcontext())
            with ctx:
                t = cuda_ms(torch, vdraws_run(VoronoiGenerator(n_points=(256,), octaves=2,
                                                               **kw), viters), 2)
            mp.setdefault(which, []).append(px * viters / (t / 1000) / 1e6)
        print(f"[14] voronoi noise {label} at {VORONOI_BENCH}, 256 points, {viters} draws "
              f"(normalized): as routed {[round(v, 2) for v in mp['kernel']]} Mpix/s, gate "
              f"closed (per-axis path) {[round(v, 2) for v in mp['plain']]} Mpix/s [{card}]")
    mp = []
    for _ in range(2):
        t = cuda_ms(torch, vdraws_run(get_noise_item("voronoi_mix"), viters), 2)
        mp.append(px * viters / (t / 1000) / 1e6)
    print(f"[14] voronoi_mix noise at {VORONOI_BENCH}: {[round(v, 2) for v in mp]} Mpix/s "
          f"[{card}]")

    src = "sonar_tpu_torch/csrc/"
    n_el = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
    rows = [
        ("fused_momentum_step", "fused.cu", "sonar_tpu/kernels/fused.py:68",
         launches["B1"], b1_err, "B1", b1_bound(n_el)),
        ("fused_scale_noise", "fused.cu", "sonar_tpu/kernels/fused.py:173",
         launches["B2"], b2_err, "B2", b2_bound(n_el)),
        ("philox_randn", "hwrng.cu", "sonar_tpu/kernels/hwrng.py:63",
         path_launches["B3"], b3_err, "B3", b3_bound(n_el)),
        ("fused_pyramid", "fused_pyramid.cu", "sonar_tpu/kernels/fused_pyramid.py:100",
         path_launches["B4"], b4_err, "B4", b4_bound(SHAPE, ladder, "bilinear", gen=True)),
        ("fused_downscale_pyramid", "fused_pyramid.cu",
         "sonar_tpu/kernels/fused_pyramid.py:264",
         sum(c["B5"] for c in down_launches.values()), b5_err, "B5",
         b5_bound(P, SHAPE, hl64, hc64, "bilinear", base=True)),
        ("voronoi_ksmallest", "voronoi.cu", "sonar_tpu/kernels/voronoi.py:78",
         vor_launches["B6"], b6_err, "B6", b6_bound(SHAPE, 256, 2)),
    ]
    for kname, _, _, n_launch, _, k, _ in rows:
        need(n_launch > 0, f"{kname} was not launched on its path")
        need(all(v is not None and v > 0 for v in dev_timing[k]),
             f"{kname}: device time not measured")
    # ms, plain_ms, library_ms: device time per call at the path's shape
    # (torch.profiler); call_ms, plain_call_ms: CUDA events, host cost included
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": n_launch, "max_abs_err": e, "ms": dev_timing[k][0] / 1000,
         "plain_ms": dev_timing[k][1] / 1000, "bound_ms": bd["us"] / 1000,
         "bound_by": bd["by"],
         "library_ms": library_us[k] / 1000 if k in library_us else None,
         "call_ms": timing[k][0], "plain_call_ms": timing[k][1]}
        for kname, f, rep, n_launch, e, k, bd in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
