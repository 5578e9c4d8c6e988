#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sonar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sonar_tpu_torch/csrc`` (into
``build/kernels/``), then:

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
   weights from a seed — and checks that it launched each kernel once per
   step; then runs one injected noise stream through the kernel path and
   through the plain path (composed momentum step, plain scale_noise), TF32
   off, and compares the trajectories;
5. times both paths end to end and each kernel against its plain version
   with CUDA events.

Every phase passes or the script exits non-zero without a result. The last
line is ``{"ok": true, "device": {...}}``. It needs one CUDA device and no
network, and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

STEPS = 20
SHAPE = (1, 4, 64, 64)
B1_SHAPES = [(1, 4, 64, 64), (4, 4, 128, 128), (1, 4, 67, 61), (1, 3, 67, 61)]
B2_SHAPES = [(1, 4, 64, 64), (4, 4, 128, 128), (1, 4, 67, 61), (1, 4, 2304, 2048)]
B1_TOL = 1e-6  # relative to max(1, |plain|): elementwise, same order of operations
B2_TOL = 1e-5  # relative to max(1, |plain|): mean/std summed in another order
TRAJ_TOL = 1e-4  # relative to max |trajectory|, TF32 off on both paths


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def need(cond, msg: str):
    if not cond:
        fail(msg)


def rel_err(a, b):
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(1.0, float(b.double().abs().max()))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_sigmas(torch):
    ramp = torch.linspace(0, 1, STEPS, dtype=torch.float64)
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
    """Mean device time per call in µs: the summed duration of the GPU
    kernels ``fn`` launches, from torch.profiler (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.time_range.end - e.time_range.start for e in kernels) / iters


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import sonar_tpu_torch.kernels.fused as F
    from sonar_tpu_torch.kernels import _build
    from sonar_tpu_torch.models import UNetConfig, init_unet_params, make_denoiser
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # -- phase 1: card, versions, build ---------------------------------------
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}")
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[1] kernels: {_build.library_path().relative_to(ROOT)} "
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

    F.fused_momentum_step.launches = 0
    F.fused_scale_noise.launches = 0
    out = headline()
    torch.cuda.synchronize()
    launches = {"B1": F.fused_momentum_step.launches, "B2": F.fused_scale_noise.launches}
    need(out.is_cuda and out.shape == SHAPE and out.dtype == torch.float32,
         f"headline output malformed: {out.shape} {out.dtype} {out.device}")
    need(bool(torch.isfinite(out).all()), "headline output is not finite")
    std = float(out.std())
    # the random UNet's epsilon is small (its output conv is scaled by 1e-2),
    # so the latent keeps roughly its starting scale sigma_0 = 14.6
    need(1.0 < std < 100.0, f"headline output std {std} implausible")
    print(f"[4] headline: UNetConfig() {SHAPE}, {STEPS} steps, seed 7: output std "
          f"{std:.4f}, mean {float(out.mean()):.4f}; launches B1={launches['B1']} "
          f"B2={launches['B2']}")
    need(launches == {"B1": STEPS, "B2": STEPS},
         f"expected {STEPS} launches of each kernel, got {launches}")
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
    for k, (kf, pf) in fns.items():
        kd, pd = device_us(torch, kf, 50), device_us(torch, pf, 50)
        fmt = lambda v: "not measured" if v is None else f"{v:.2f} us"  # noqa: E731
        print(f"[5] {k} at {SHAPE}: device time per call (torch.profiler, summed "
              f"kernels): kernel {fmt(kd)}, plain {fmt(pd)} [{card}]")
    big = [randn((4, 4, 128, 128)) for _ in range(4)]
    b1_big = cuda_ms(torch, lambda: F.fused_momentum_step(*big, scal), 200)
    gbs = 24 * big[0].numel() / (b1_big / 1000) / 1e9
    large = randn(B2_SHAPES[-1]) * 1.3 + 0.2
    b2_big = cuda_ms(torch, lambda: F.fused_scale_noise(large), 20)
    b2_plain_big = cuda_ms(torch, lambda: F.fused_scale_noise_reference(large), 20)
    print(f"[5] B1 at (4, 4, 128, 128): {b1_big * 1000:.2f} us/call, "
          f"{gbs:.0f} GB/s at 24 B/element [{card}]")
    print(f"[5] B2 at {B2_SHAPES[-1]}: kernel {b2_big * 1000:.1f} us/call "
          f"({16 * large.numel() / (b2_big / 1000) / 1e9:.0f} GB/s at 16 B/element), "
          f"plain {b2_plain_big * 1000:.1f} us/call [{card}]")

    src = "sonar_tpu_torch/csrc/fused.cu"
    print(json.dumps({"kernels": [
        {"name": "fused_momentum_step", "route": "cuda", "source": src,
         "replaces": "sonar_tpu/kernels/fused.py:68", "launches": launches["B1"],
         "max_abs_err": b1_err, "ms": timing["B1"][0], "plain_ms": timing["B1"][1]},
        {"name": "fused_scale_noise", "route": "cuda", "source": src,
         "replaces": "sonar_tpu/kernels/fused.py:173", "launches": launches["B2"],
         "max_abs_err": b2_err, "ms": timing["B2"][0], "plain_ms": timing["B2"][1]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
