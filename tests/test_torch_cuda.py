"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels) and
skip without one. They import nothing of JAX, so the card's machine runs
them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: B1 1e-6 relative to max(1, |plain|) (elementwise, same order of
operations, no FMA contraction); B2 1e-5 (its mean and std sum in another
order than torch's reductions) at every size, in each of its three
launches (one block, one cluster, one cooperative grid) and bit for bit
across runs and alignments; B3 uniforms bit for bit and normals 2e-6
absolute (the kernel's polynomials for the logarithm, sine and cosine and
its rsqrt against torch's functions on the same arguments, a few ulps of
values up to ~5.8), a bfloat16 or float16 draw equal to the float32 draw
rounded once; B4 and B5 1e-5 relative to max(1, |plain|)
(B4 gathers the nonzero taps of the matrices its plain version multiplies
by, so its sums run in another order; B5 inherits B3's ulps), with matmul
TF32 off for the plain versions.

B1 and B2 on bfloat16 and float16 latents compute in float32 and round once
to the working type, as the JAX kernels' float32 scalars promote their
arithmetic: each is held against its plain version run on the float32
upcast of the same inputs and rounded to the working type, within one ulp
of that type relative to max(1, |plain|) (2^-7 bf16, 2^-10 fp16; B1 comes
out bit-equal, B2's mean and std may move a rounding by one ulp), and
against the plain version run in the working type, which rounds each of
its ~10 steps, within 2^-4 (bf16) and 2^-7 (fp16) relative to
max(1, |plain|). The bf16 sampler run against ``use_fused=False`` (20 steps,
the carry rounded to bf16 at other points on the two paths): 0.1 relative
to the trajectory's largest magnitude (0.034 in a CPU simulation).

B6 against its plain version: bit for bit for euclidean, quadratic and
chebyshev (same operations in the same order, no FMA contraction, sqrtf
correctly rounded, so the roots of the k smallest squares are the k
smallest roots); minkowski within 1e-6 relative to max(1, |plain|) (both
take powf on the card; torch special-cases p = 2 and 3, and the kernel
follows it).

Wavelet CFG and the DWT (torch ops, no kernel of their own) on the card
against the same calls on the CPU: 1e-5 relative to max(1, |cpu|), and a
guided call of the config-3 pipeline under
``torch.cuda.set_sync_debug_mode("error")``.

FreeU-Extreme's three spectral operators with the global TF32 switches on
and off (dense K 3e-6 and the factor pair 3e-5 from the FFT, the card's FFT
1e-5 from the CPU's) and a patched UNet forward under the same sync check;
the 17 noise names of configs 2 and 4's slice and config 5's video noise,
one seed on the CPU and the card, 1e-5.

The rest of the noise zoo: the DTCWT on the card against the CPU and its
reconstruction, 1e-5, with the TF32 switches on and off; the distributions
on one seed, CPU against card, the transforms 1e-5 relative to
max(1, |cpu|) and the rejection samplers by their share of elements past
it (under 1e-3: an accept test that lands within an ulp of its edge may
decide otherwise where kernel B3's normals differ by an ulp); distro,
collatz and scatternet noise 1e-5; wavelet CFG on the DTCWT 1e-5 and with no
synchronisation, and the new noises under the sampler with none either.
"""

import copy

import numpy as np
import pytest
import torch

import sonar_tpu_torch.kernels.fused as F
import sonar_tpu_torch.kernels.fused_pyramid as P
import sonar_tpu_torch.kernels.voronoi as V
from sonar_tpu_torch.kernels import hwrng as H
from sonar_tpu_torch.noise.generators import _size_ladder_highres, _size_ladder_pyramid

# one ulp of the working type, and the bound against the plain version run in it
LOW_PRECISION = {torch.bfloat16: (2.0**-7, 2.0**-4), torch.float16: (2.0**-10, 2.0**-7)}

GATES = [(h, i, w, 0.5) for h in (0.0, 1.0) for i in (0.0, 1.0) for w in (0.0, 1.0)]
GATES.append((1.0, 1.0, 1.0, 0.0))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        1.0, float(b.double().abs().max()))


def _randn(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (1, 4, 67, 61), (1, 3, 67, 61)])
@pytest.mark.parametrize("gates", GATES)
def test_momentum_kernel_matches_plain(cuda, shape, gates):
    ts = [_randn(shape, cuda, seed) for seed in range(4)]
    has, inw, hw, ns = gates
    scal = F.pack_momentum_scalars(sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75,
                                   hd_scale=1.05, md_scale=1.0, has=has, noise_scale=ns,
                                   in_window=inw, hist_window=hw, device=cuda)
    n = F.fused_momentum_step.launches
    out = F.fused_momentum_step(*ts, scal)
    assert F.fused_momentum_step.launches == n + 1
    for o, r in zip(out, F.fused_momentum_step_reference(*ts, scal)):
        assert _rel_err(o, r) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (1, 3, 7, 5)])
@pytest.mark.parametrize("case", ["shifted", "scaled", "both", "zeros", "factor"])
def test_scale_noise_kernel_matches_plain(cuda, shape, case):
    base = _randn(shape, cuda)
    x, factor = {
        "shifted": (base + 0.5, 1.0),
        "scaled": (base * 3.0, 1.0),
        "both": (base * 3.0 - 1.0, 1.0),
        "zeros": (torch.zeros(shape, device=cuda), 1.0),
        "factor": (base * 2.0 + 0.25, 1.7),
    }[case]
    n = F.fused_scale_noise.launches
    out = F.fused_scale_noise(x, factor)
    assert F.fused_scale_noise.launches == n + 1
    assert _rel_err(out, F.fused_scale_noise_reference(x, factor)) <= 1e-5
    assert torch.equal(out, F.fused_scale_noise(x, factor))


def _scale_noise_sizes():
    """Element counts around each size where B2's launch changes, plus tails
    (counts that are not a multiple of the 16-byte unit)."""
    caps = (F.SCALE_NOISE_BLOCK_ELEMS, F.SCALE_NOISE_CLUSTER_ELEMS)
    return [1003, *(c + d for c in caps for d in (-1, 0, 1)), 3 * caps[1] + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_scale_noise_kernel_tiers_alignment_and_tails(cuda, dtype, aligned):
    tol = 1e-5 if dtype == torch.float32 else LOW_PRECISION[dtype][0]
    tiers = set()
    for n in _scale_noise_sizes():
        tiers.add(F.scale_noise_tier(n, torch.empty(0, dtype=dtype).element_size()))
        flat = (_randn((n + 1,), cuda, n % 97) * 2.0 + 0.25).to(dtype)
        x = flat[:n].clone() if aligned else flat[1:]  # the view starts off a 16-byte line
        assert (x.data_ptr() % 16 == 0) == aligned
        out = F.fused_scale_noise(x, 1.7)
        want = F.fused_scale_noise_reference(x.float(), 1.7).to(dtype)
        err = (out.double() - want.double()).abs() / want.double().abs().clamp(min=1)
        assert out.dtype == dtype and float(err.max()) <= tol, n
        assert torch.equal(out, F.fused_scale_noise(x, 1.7)), n
        # the unit's tree does not depend on how it was loaded
        assert torch.equal(out, F.fused_scale_noise(x.clone(), 1.7)), n
        zeros = torch.zeros_like(x)
        assert torch.equal(F.fused_scale_noise(zeros), zeros), n
    assert tiers == {1, 2, 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (1, 3, 67, 61)])
def test_low_precision_momentum_and_scale_noise(cuda, dtype, shape):
    ulp, plain_tol = LOW_PRECISION[dtype]
    ts = [_randn(shape, cuda, seed).to(dtype) for seed in range(4)]
    for has, inw, hw, ns in GATES:
        scal = F.pack_momentum_scalars(sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75,
                                       hd_scale=1.05, md_scale=1.0, has=has, noise_scale=ns,
                                       in_window=inw, hist_window=hw, device=cuda)
        out = F.fused_momentum_step(*ts, scal)
        up = F.fused_momentum_step_reference(*(t.float() for t in ts), scal)
        low = F.fused_momentum_step_reference(*ts, scal)
        for o, u, q in zip(out, up, low):
            assert o.dtype == dtype
            assert torch.equal(o, u.to(dtype))
            assert _rel_err(o, q) <= plain_tol
    for x, factor in ((ts[0] * 3 + 0.5, 1.0), (ts[1] * 2 + 0.25, 1.7), (ts[2], 1.0)):
        x = x.to(dtype)
        n = F.fused_scale_noise.launches
        out = F.fused_scale_noise(x, factor)
        assert F.fused_scale_noise.launches == n + 1 and out.dtype == dtype
        want = F.fused_scale_noise_reference(x.float(), factor).to(dtype)
        err = (out.double() - want.double()).abs() / want.double().abs().clamp(min=1)
        assert float(err.max()) <= ulp
        assert _rel_err(out, F.fused_scale_noise_reference(x, factor)) <= plain_tol
        assert torch.equal(out, F.fused_scale_noise(x, factor))


@pytest.mark.cuda
def test_bf16_latent_runs_the_sampler_on_the_card(cuda):
    """The repaired fault: a bf16 latent used to raise at its first
    scale_noise on the card. It now runs B1, B2 and B3 once per step."""
    from sonar_tpu_torch.samplers.sonar import sample_sonar_euler_ancestral

    shape, steps = (1, 4, 64, 64), 20
    ramp = torch.linspace(0, 1, steps, dtype=torch.float64)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    sigmas = torch.cat([s, torch.zeros(1, dtype=torch.float64)]).float()
    target = (torch.arange(4 * 64 * 64, dtype=torch.float32, device=cuda).reshape(shape)
              / 1e3).to(torch.bfloat16)

    def stub(x, sig, **_):
        return ((x * 0.9 + target) / (1.0 + sig.reshape(-1, 1, 1, 1) * 0.05)).to(x.dtype)

    x0 = (_randn(shape, cuda, 1) * 14.6).to(torch.bfloat16)
    counts = (F.fused_momentum_step.launches, F.fused_scale_noise.launches,
              H.philox_randn.launches)
    out = sample_sonar_euler_ancestral(stub, x0, sigmas, seed=7)
    torch.cuda.synchronize()
    assert (F.fused_momentum_step.launches - counts[0], F.fused_scale_noise.launches - counts[1],
            H.philox_randn.launches - counts[2]) == (steps, steps, steps)
    assert out.dtype == torch.bfloat16 and out.is_cuda and torch.isfinite(out).all()
    plain = sample_sonar_euler_ancestral(stub, x0, sigmas, seed=7, use_fused=False)
    err = float((out.double() - plain.double()).abs().max())
    assert plain.dtype == torch.bfloat16
    assert err <= 0.1 * float(plain.double().abs().max())


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(TypeError):
        F.fused_scale_noise(torch.zeros((1, 4, 8, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):  # no integer kernel either
        F.fused_scale_noise(torch.zeros((1, 4, 8, 8), device=cuda, dtype=torch.int32))
    with pytest.raises(TypeError):  # mixed dtypes
        z = torch.zeros((1, 4, 8, 8), device=cuda)
        F.fused_momentum_step(z, z, z, z.half(), F.pack_momentum_scalars(
            sigma=1.0, dt=-0.5, momentum=0.9, hd_ratio=0.75, hd_scale=1.0, md_scale=1.0,
            has=0.0, noise_scale=0.0, device=cuda))
    x = torch.zeros((1, 4, 8, 8), device=cuda)
    scal = F.pack_momentum_scalars(sigma=1.0, dt=-0.5, momentum=0.9, hd_ratio=0.75,
                                   hd_scale=1.0, md_scale=1.0, has=0.0, noise_scale=0.0)
    with pytest.raises(ValueError):  # scalars left on the host
        F.fused_momentum_step(x, x, x, x, scal)
    with pytest.raises(ValueError):  # mismatched shapes
        F.fused_momentum_step(x, x, x, x[..., :4].contiguous(), scal.to(cuda))


def _views(base):
    """Tensors the CPU path takes that are not contiguous."""
    return {
        "transpose": base.transpose(2, 3), "slice": base[:, 1:3, ::2],
        "channels_last": base.contiguous(memory_format=torch.channels_last),
        "irfft2": torch.fft.irfft2(torch.fft.rfft2(base.float()),
                                   s=base.shape[-2:]).swapaxes(0, 1).to(base.dtype),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["transpose", "slice", "channels_last", "irfft2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_views_go_through_the_kernels_after_one_counted_copy(cuda, view, dtype):
    """B1 and B2 on tensors that are not contiguous: one copy each (counted),
    then the kernel, with the bits it gives the contiguous copy."""
    base = (_randn((2, 4, 12, 10), cuda, 3) * 2.0 + 0.3).to(dtype)
    x = _views(base)[view]
    assert not x.is_contiguous()
    n, c = F.fused_scale_noise.launches, F.fused_scale_noise.copies
    out = F.fused_scale_noise(x, 1.3)
    assert (F.fused_scale_noise.launches, F.fused_scale_noise.copies) == (n + 1, c + 1)
    assert out.shape == x.shape and out.dtype == dtype
    assert torch.equal(out, F.fused_scale_noise(x.contiguous(), 1.3))
    assert F.fused_scale_noise.copies == c + 1  # a contiguous tensor is not copied
    ref = F.fused_scale_noise_reference(x.float(), 1.3).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else LOW_PRECISION[dtype][0]
    assert _rel_err(out, ref) <= tol
    scal = F.pack_momentum_scalars(sigma=3.0, dt=-1.0, momentum=0.9, hd_ratio=0.75,
                                   hd_scale=1.0, md_scale=1.0, has=1.0, noise_scale=0.3,
                                   device=cuda)
    n, c = F.fused_momentum_step.launches, F.fused_momentum_step.copies
    den = torch.zeros_like(x.contiguous())
    got = F.fused_momentum_step(x, den, x, den, scal)  # x and hd are views: two copies
    assert (F.fused_momentum_step.launches, F.fused_momentum_step.copies) == (n + 1, c + 2)
    want = F.fused_momentum_step(x.contiguous(), den, x.contiguous(), den, scal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_float64_on_the_card_raises_and_launches_nothing(cuda):
    """The kernels compute in float32 and have no float64 instantiation: a
    float64 CUDA tensor raises, whether contiguous or a view; the wrappers
    never hand a tensor on the card to the plain version."""
    x = _randn((1, 4, 9, 8), cuda, 4).double() * 3.0 + 1.0
    scal = F.pack_momentum_scalars(sigma=3.0, dt=-1.0, momentum=0.9, hd_ratio=0.75,
                                   hd_scale=1.0, md_scale=1.0, has=1.0, noise_scale=0.3,
                                   device=cuda)
    counts = (F.fused_scale_noise.launches, F.fused_momentum_step.launches)
    for t in (x, x.transpose(2, 3)):
        with pytest.raises(TypeError, match="float64"):
            F.fused_scale_noise(t, 0.5)
        with pytest.raises(TypeError, match="float64"):
            F.fused_momentum_step(t, t * 0.5, t * 0.1, t * 2.0, scal)
    assert (F.fused_scale_noise.launches, F.fused_momentum_step.launches) == counts


@pytest.mark.cuda
def test_power_noise_on_the_card_goes_through_b2_and_b3(cuda):
    """The config-3a noise on the card: irfft2's output and the channel
    mix's swapaxes reach scale_noise; one seed gives the CPU's noise."""
    from sonar_tpu_torch.noise import (PowerNoiseItem, ScheduledNoise, get_noise_item,
                                       make_noise_sampler)

    item = ScheduledNoise(
        noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True, common_mode=0.4),
        start_sigma=14.7, end_sigma=0.3, fallback_noise=get_noise_item("gaussian"))
    kw = dict(seed=5, sigma_min=0.03, sigma_max=14.6)
    cfn, cst = make_noise_sampler(item, (1, 4, 64, 64), device="cpu", **kw)
    gfn, gst = make_noise_sampler(item, (1, 4, 64, 64), device=cuda, **kw)
    n2, n3 = F.fused_scale_noise.launches, H.philox_randn.launches
    for s, sn in ((14.6, 9.0), (9.0, 4.0), (0.2, 0.1)):
        a, cst = cfn(cst, s, sn)
        b, gst = gfn(gst, s, sn)
        assert b.is_cuda and _rel_err(b.cpu(), a) <= 1e-5
    assert F.fused_scale_noise.launches == n2 + 3
    assert H.philox_randn.launches == n3 + 34 + 17 + 1  # a miss, a hit, the gaussian


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (1, 4, 67, 61), (7,)])
@pytest.mark.parametrize("seed,stream", [(0, 0), (7, 0), (2**40 + 3, 5)])
def test_philox_kernel_matches_plain(cuda, shape, seed, stream):
    n1, n2 = H.philox_randn.launches, H.philox_rand.launches
    u = H.philox_rand(seed, shape, device=cuda, stream=stream)
    z = H.philox_randn(seed, shape, device=cuda, stream=stream)
    assert (H.philox_randn.launches, H.philox_rand.launches) == (n1 + 1, n2 + 1)
    assert torch.equal(u, H.philox_rand_reference(seed, shape, device=cuda, stream=stream))
    zr = H.philox_randn_reference(seed, shape, device=cuda, stream=stream)
    assert float((z - zr).abs().max()) <= 2e-6
    assert torch.equal(z, H.philox_randn(seed, shape, device=cuda, stream=stream))
    zc = H.philox_randn(seed, shape, device="cpu", stream=stream)
    assert float((z.cpu() - zc).abs().max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [1, 2, 3, 16385, 270338, 270343, 1 << 20])
def test_philox_kernel_dtypes_and_ragged_counts(cuda, dtype, n):
    """Counts with n % 4 in {1, 2, 3} and 0, on both of B3's kernels (one
    group a thread below 67,584 groups, two above): a 2-byte draw is the
    float32 draw rounded once, which is what the plain version's .to gives."""
    z32 = H.philox_randn(3, (n,), device=cuda, stream=2)
    zr = H.philox_randn_reference(3, (n,), device=cuda, stream=2)
    assert float((z32 - zr).abs().max()) <= 2e-6
    z = H.philox_randn(3, (n,), device=cuda, stream=2, dtype=dtype)
    assert z.dtype == dtype and z.shape == (n,) and torch.equal(z, z32.to(dtype))
    u = H.philox_rand(3, (n,), device=cuda, stream=2, dtype=dtype)
    assert torch.equal(u, H.philox_rand_reference(3, (n,), device=cuda, stream=2, dtype=dtype))
    # nothing is written past the end of a ragged draw
    canvas = H.philox_randn(3, (n + 8,), device=cuda, stream=2, dtype=dtype)
    assert torch.equal(canvas[:n - n % 4], z[:n - n % 4])


@pytest.mark.cuda
def test_box_muller_factors_over_every_argument(cuda):
    """All 2^24 radii and all 2^24 sines and cosines against float64: the
    worst normal they imply stays inside B3's 2e-6."""
    import math

    from sonar_tpu_torch.kernels import _build

    lib, n = _build.load_library(), 1 << 24
    probe = torch.empty((3, n), device=cuda)
    _build.check(lib, lib.sonar_box_muller_probe(
        probe[0].data_ptr(), probe[1].data_ptr(), probe[2].data_ptr(), 0, n,
        torch.cuda.current_stream().cuda_stream), "box_muller_probe")
    arg = torch.arange(n, device=cuda, dtype=torch.float64)
    radius = torch.sqrt(-2.0 * torch.log((arg + 1.0) * 2.0**-24))
    theta = arg * (2.0 * math.pi * 2.0**-24)
    dr = (probe[0].double() - radius).abs()
    dc = max(float((probe[1].double() - torch.cos(theta)).abs().max()),
             float((probe[2].double() - torch.sin(theta)).abs().max()))
    assert dc <= 1.2e-7 and float(dr.max()) <= 5e-7
    assert float((dr + probe[0].double() * dc).max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 64), (67, 61)])
def test_pyramid_kernels_draw_the_philox_stream(cuda, hw):
    """B4's base pair and B5's fields are philox_randn's normals: with the
    levels below the base discounted to 0, B4 returns stream 0 plus the
    level-0 discount times stream 1 of the base seed, as B3 draws them; B5
    is held to its plain version, which draws its fields with B3's plain
    version."""
    from sonar_tpu_torch.core.rng import derive_seed

    h, w = hw
    shape = (1, 4, h, w)
    up = P.fused_pyramid(11, shape, [hw, (1, 1)], 0.0, "nearest", device=cuda)
    bseed = derive_seed(11, "base")
    pair = (H.philox_randn(bseed, (4, h, w), device=cuda, stream=0)
            + H.philox_randn(bseed, (4, h, w), device=cuda, stream=1) * P._LEVEL0_DISCOUNT)
    assert float((up[0] - pair).abs().max()) <= 1e-6
    sizes = [(2 * h, 2 * w), (4 * h, 4 * w)]
    assert P.fused_downscale_supported(sizes, h, w, "nearest-exact")
    down = P.fused_downscale_pyramid(13, shape, sizes, [1.0, 0.5], "nearest-exact",
                                     device=cuda)
    ref = P.fused_downscale_pyramid_reference(13, shape, sizes, [1.0, 0.5], "nearest-exact",
                                              device=cuda)
    assert float((down - ref).abs().max()) <= 2e-6 * 1.5


def _pyramid_case(hw):
    return hw, _size_ladder_pyramid(*hw, 10, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", P.UP_MODES)
@pytest.mark.parametrize("hw", [(64, 64), (67, 61), (512, 512), (263, 260)])
def test_pyramid_kernel_matches_plain(cuda, mode, hw):
    (h, w), sizes = _pyramid_case(hw)
    n = P.fused_pyramid.launches
    out = P.fused_pyramid(3, (1, 4, h, w), sizes, 0.7, mode, device=cuda)
    assert P.fused_pyramid.launches == n + 1
    ref = P.fused_pyramid_reference(3, (1, 4, h, w), sizes, 0.7, mode, device=cuda)
    assert _rel_err(out, ref) <= 1e-5
    base = _randn((4, h, w), cuda, 1)
    smalls = [_randn((4, sh, sw), cuda, 2 + i) for i, (sh, sw) in enumerate(sizes[1:])]
    disc = [0.7**i for i in range(1, len(sizes))]
    got = P.fused_pyramid_accumulate(base, smalls, disc, mode)
    assert _rel_err(got, P.fused_pyramid_accumulate_reference(base, smalls, disc, mode)) <= 1e-5


# ladders that stress B4's tap tables: bicubic's clamped edge taps on 2- and
# 3-wide levels, widths and element counts that are not multiples of 4 (a
# thread's four elements then cross rows and planes), a level as tall as the
# output, a 1x1 level, the sixteen levels the kernel takes at most
PYR_EDGE = [((8, 6), [(3, 2), (2, 3), (1, 1)]),
            ((5, 7), [(5, 3), (1, 7), (2, 2)]),
            ((33, 130), [(33, 47), (12, 130), (3, 3), (1, 1)]),
            ((16, 18), [(max(1, 16 - i), max(1, 18 - 2 * i)) for i in range(1, 17)])]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", P.UP_MODES)
@pytest.mark.parametrize("case", range(len(PYR_EDGE)))
@pytest.mark.parametrize("bc", [1, 3])
def test_pyramid_kernel_edge_ladders(cuda, mode, case, bc):
    (h, w), below = PYR_EDGE[case]
    sizes = [(h, w), *below]
    out = P.fused_pyramid(3, (1, bc, h, w), sizes, 0.7, mode, device=cuda)
    ref = P.fused_pyramid_reference(3, (1, bc, h, w), sizes, 0.7, mode, device=cuda)
    assert out.shape == ref.shape and _rel_err(out, ref) <= 1e-5
    base = _randn((bc, h, w), cuda, 1)
    smalls = [_randn((bc, sh, sw), cuda, 2 + i) for i, (sh, sw) in enumerate(below)]
    disc = [0.7**i for i in range(1, len(sizes))]
    n = P.fused_pyramid_accumulate.launches
    got = P.fused_pyramid_accumulate(base, smalls, disc, mode)
    assert P.fused_pyramid_accumulate.launches == n + 1
    assert _rel_err(got, P.fused_pyramid_accumulate_reference(base, smalls, disc, mode)) <= 1e-5


def _down_cases():
    out = []
    for h, w in [(64, 64), (128, 128), (67, 61)]:
        old = [(h * 2 ** (i + 1), w * 2 ** (i + 1)) for i in range(5)]
        out.append(((h, w), old, [(0.5**i) * 0.8**i for i in range(5)]))
        hi = _size_ladder_highres(h, w, 4, 0)
        out.append(((h, w), hi, [0.7**i for i in range(len(hi))]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", P.DOWN_MODES)
@pytest.mark.parametrize("case", range(6))
def test_downscale_kernel_matches_plain(cuda, mode, case):
    (h, w), sizes, coefs = _down_cases()[case]
    if not P.fused_downscale_supported(sizes, h, w, mode):
        pytest.skip(f"ladder {sizes} is not B5's in mode {mode} (the composed path's)")
    for base in (None, _randn((1, 4, h, w), cuda, 5)):
        out = P.fused_downscale_pyramid(9, (1, 4, h, w), sizes, coefs, mode, base=base,
                                        device=cuda)
        ref = P.fused_downscale_pyramid_reference(9, (1, 4, h, w), sizes, coefs, mode,
                                                  base=base, device=cuda)
        assert _rel_err(out, ref) <= 1e-5
    gs = [_randn((4, 4, h, w), cuda, 10 + i) for i in range(len(sizes))]
    got = P.fused_downscale_accumulate(gs, (h, w), sizes, coefs, mode)
    want = P.fused_downscale_accumulate_reference(gs, (h, w), sizes, coefs, mode)
    assert _rel_err(got, want) <= 1e-5


def _forced(variant, fn, *args, **kw):
    """``fn(*args, **kw)`` with B5's kernel ``variant`` forced (None: the pick)."""
    with P._forced_down_variant(variant):
        return fn(*args, **kw)


# B5's two kernels around the size where the wrapper changes from one to the
# other (±1 Philox group, ±1 element), shapes whose last group is ragged and
# whose groups straddle rows and planes, and one block more or less of the
# spread kernel (32 groups)
def _down_limit_shapes():
    cap = P.DOWN_SPREAD_ELEMS
    return [(1, 1, 1, cap - 4), (1, 1, 1, cap - 1), (1, 1, 1, cap), (1, 1, 1, cap + 1),
            (1, 1, 1, cap + 4), (1, 1, 2, cap // 2), (1, 3, 5, 7), (2, 3, 33, 130),
            (1, 1, 1, 1), (1, 1, 1, 127), (1, 1, 1, 128), (1, 1, 1, 129), (1, 4, 67, 61),
            (1, 2, 3, 1), (1, 5, 2, 2)]  # a group's rows wrap round a plane to its first


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest-exact", "area"])
@pytest.mark.parametrize("case", range(15))
def test_downscale_kernels_agree_bit_for_bit(cuda, mode, case):
    """Both of B5's kernels, forced on every shape: bit-equal to each other
    on drawn fields (the draw does not depend on which ran) and within 1e-5
    of the plain version; bit-equal to the plain version on given fields,
    with and without a base; and the wrapper picks by the element count."""
    shape = _down_limit_shapes()[case]
    b, c, h, w = shape
    sizes = [(h, w), (2 * h, 3 * w), (4 * h, 4 * w), (15 * h, 15 * w)]
    coefs = [0.7**i for i in range(len(sizes))]
    assert P.fused_downscale_supported(sizes, h, w, mode)
    assert P.downscale_variant(b * c * h * w) == (1 if b * c * h * w <= P.DOWN_SPREAD_ELEMS
                                                  else 2)
    for base in (None, _randn(shape, cuda, 5)):
        ref = P.fused_downscale_pyramid_reference(9, shape, sizes, coefs, mode, base=base,
                                                  device=cuda)
        outs = [_forced(v, P.fused_downscale_pyramid, 9, shape, sizes, coefs, mode,
                        base=base, device=cuda) for v in (1, 2, None)]
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
        assert _rel_err(outs[0], ref) <= 1e-5
        gs = [_randn((b * c, 4, h, w), cuda, 10 + i) for i in range(len(sizes))]
        b3 = None if base is None else base.reshape(b * c, h, w)
        want = P.fused_downscale_accumulate_reference(gs, (h, w), sizes, coefs, mode, base=b3)
        for v in (1, 2, None):
            got = _forced(v, P.fused_downscale_accumulate, gs, (h, w), sizes, coefs, mode,
                          base=b3)
            assert torch.equal(got, want), (v, float((got - want).abs().max()))


@pytest.mark.cuda
def test_downscale_kernel_takes_sixteen_levels_and_an_unaligned_base(cuda):
    """MAX_LEVELS bilinear levels are 64 fields (the spread kernel's warps
    take four each); a base view that is not 16-byte aligned loads by
    elements in the kernel that reads it as float4."""
    h, w = 9, 12
    sizes = [((2 + i) * h, (2 + i) * w) for i in range(P.MAX_LEVELS)]
    coefs = [0.9**i for i in range(len(sizes))]
    flat = _randn((1 + 2 * h * w,), cuda, 2)
    base = flat[1:].view(1, 2, h, w)
    assert base.data_ptr() % 16 != 0
    ref = P.fused_downscale_pyramid_reference(3, (1, 2, h, w), sizes, coefs, "bilinear",
                                              base=base, device=cuda)
    outs = [_forced(v, P.fused_downscale_pyramid, 3, (1, 2, h, w), sizes, coefs, "bilinear",
                    base=base, device=cuda) for v in (1, 2)]
    for out in outs:
        assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_pyramid_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="not supported"):
        P.fused_pyramid(0, (1, 4, 16, 16), [(8, 8)], 0.7, device=cuda)
    base = torch.zeros((4, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        P.fused_pyramid_accumulate(base, [torch.zeros((4, 4, 4), device=cuda).half()], [0.5])
    with pytest.raises(ValueError):
        P.fused_downscale_accumulate([torch.zeros((4, 4, 8, 8), device=cuda)], (16, 16),
                                     [(32, 32)], [1.0])


B6_SHAPES = [(1, 4, 64, 64), (1, 3, 67, 61), (2, 2, 9, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("dist,p", [("euclidean", 3.0), ("quadratic", 3.0),
                                    ("chebyshev", 3.0), ("minkowski", 2.5)])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_voronoi_kernel_matches_plain(cuda, dist, p, k):
    g = torch.Generator(device=cuda).manual_seed(k)
    for n in (37, 256, 4096):  # 4,096 points cross B6's 1,024-point chunks
        for b, c, h, w in B6_SHAPES:
            fp = torch.rand((b, c, n, 3), generator=g, device=cuda)
            ys = torch.arange(h, dtype=torch.float32, device=cuda) / h
            xs = torch.arange(w, dtype=torch.float32, device=cuda) / w
            z = torch.tensor(0.37, device=cuda)
            for scale, weights in ((1.0, (1.0, 1.0, 1.0)), (8.0, (2.0, 1.0, 0.25))):
                kw = dict(scale=scale, k=k, dist=dist, p=p, weights=weights)
                launches = V.voronoi_ksmallest.launches
                out = V.voronoi_ksmallest(fp, ys, xs, z, **kw)
                assert V.voronoi_ksmallest.launches == launches + 1
                ref = V.voronoi_ksmallest_reference(fp, ys, xs, z, **kw)
                assert out.shape == (b, c, h, w, k) and out.dtype == torch.float32
                if dist == "minkowski":
                    assert _rel_err(out, ref) <= 1e-6
                else:
                    assert torch.equal(out, ref), (n, (b, c, h, w), scale)


def _voronoi_agrees(out, ref, dist):
    assert out.shape == ref.shape and out.dtype == torch.float32
    if dist == "minkowski":
        assert _rel_err(out, ref) <= 1e-6
    else:
        assert torch.equal(out, ref)


# the tile heights B6 picks (4, 8, 16 and 32 rows: 8, 4, 2 and 1 parts of the points)
B6_TILE_SHAPES = [(1, 1, 8, 8), (1, 3, 128, 128), (1, 2, 256, 160), (4, 4, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dist,p", [("euclidean", 3.0), ("quadratic", 3.0),
                                    ("chebyshev", 3.0), ("minkowski", 2.5)])
@pytest.mark.parametrize("shape", B6_TILE_SHAPES)
def test_voronoi_kernel_tiles_and_point_splits(cuda, dist, p, shape):
    """Every tile height, with point counts that do not divide by the split
    (13, 100), k = N = 8, and parts that hold fewer than k points."""
    b, c, h, w = shape
    g = torch.Generator(device=cuda).manual_seed(h)
    ys = torch.arange(h, dtype=torch.float32, device=cuda) / h
    xs = torch.arange(w, dtype=torch.float32, device=cuda) / w
    for n in (8, 13, 100):
        fp = torch.rand((b, c, n, 3), generator=g, device=cuda)
        for k in (1, 3, 8):
            kw = dict(scale=3.0, k=k, dist=dist, p=p, weights=(1.0, 1.5, 0.5))
            _voronoi_agrees(V.voronoi_ksmallest(fp, ys, xs, 0.37, **kw),
                            V.voronoi_ksmallest_reference(fp, ys, xs, 0.37, **kw), dist)


@pytest.mark.cuda
@pytest.mark.parametrize("dist,p", [("euclidean", 3.0), ("quadratic", 3.0),
                                    ("chebyshev", 3.0), ("minkowski", 2.5)])
def test_voronoi_kernel_takes_the_generators_views(cuda, dist, p):
    """Strided views of the (H, W, 3) grid, a 0-dim z on the card, points
    outside [0, 1) (negative arguments of the wraps)."""
    h, w = 67, 61
    ys = torch.arange(h, dtype=torch.float32, device=cuda) / h
    xs = torch.arange(w, dtype=torch.float32, device=cuda) / w
    grid3d = torch.cat([torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1),
                        torch.tensor(0.81, device=cuda).expand(h, w, 1)], dim=-1)
    fp = torch.rand((1, 3, 50, 3), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda) * 3.0 - 1.0
    args = (fp, grid3d[:, 0, 0], grid3d[0, :, 1], grid3d[0, 0, 2])
    kw = dict(scale=2.0, k=2, dist=dist, p=p)
    _voronoi_agrees(V.voronoi_ksmallest(*args, **kw),
                    V.voronoi_ksmallest_reference(*args, **kw), dist)


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda):
    from sonar_tpu_torch.models import UNetConfig, init_unet_params
    from sonar_tpu_torch.noise import (NoiseSamplerHandle, VoronoiGenerator, get_noise_item,
                                       make_noise_sampler)

    fn, st = make_noise_sampler(VoronoiGenerator(), (1, 4, 16, 16), seed=1)
    n = V.voronoi_ksmallest.launches
    noise, _ = fn(st, 1.0, 0.5)
    assert noise.is_cuda and V.voronoi_ksmallest.launches == n + 1  # f1 takes B6
    assert NoiseSamplerHandle(get_noise_item("gaussian"), (1, 4, 16, 16), seed=1)().is_cuda
    cfg = UNetConfig(model_channels=32, channel_mult=(1, 2), attention_levels=(1,))
    model = init_unet_params(torch.Generator().manual_seed(0), cfg)
    assert all(p.is_cuda for p in model.parameters())


@pytest.mark.cuda
def test_voronoi_kernel_refuses_what_it_cannot_take(cuda):
    fp = torch.rand((1, 4, 5, 3), device=cuda)
    ys = torch.arange(8, dtype=torch.float32, device=cuda) / 8
    for bad in (dict(k=9), dict(k=6), dict(k=2, dist="angle")):
        with pytest.raises(ValueError):
            V.voronoi_ksmallest(fp, ys, ys, 0.0, scale=1.0, **bad)
    with pytest.raises(ValueError, match="on cpu"):
        V.voronoi_ksmallest(fp, ys.cpu(), ys, 0.0, scale=1.0, k=2)


# ---------------------------------------------------------------------------
# wavelet CFG on the card (no kernel of its own: torch ops). Tolerance 1e-5
# relative to max(1, |cpu|): float32 products and sums in another order; TF32
# off for the UNet's convolutions in the guided call.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodization", "symmetric", "reflect", "zero"])
@pytest.mark.parametrize("wave", ["db4", "haar", "bior2.2"])
def test_dwt_on_the_card_matches_the_cpu(cuda, mode, wave):
    from sonar_tpu_torch.wavelets import dwt1d, dwt2d, idwt1d, idwt2d

    for shape in ((1, 4, 128, 128), (2, 3, 13, 9)):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
        cl, ch = dwt2d(x, wave, 3, mode)
        gl, gh = dwt2d(x.to(cuda), wave, 3, mode)
        assert gl.is_cuda and _rel_err(gl.cpu(), cl) <= 1e-5
        assert all(_rel_err(g.cpu(), c) <= 1e-5 for g, c in zip(gh, ch))
        back = idwt2d(gl, gh, wave, mode, out_hw=shape[-2:])
        assert _rel_err(back.cpu(), idwt2d(cl, ch, wave, mode, out_hw=shape[-2:])) <= 1e-5
        assert _rel_err(back.cpu(), x) <= 1e-5
        flat = x.reshape(shape[0], shape[1], -1)
        g1 = dwt1d(flat.to(cuda), wave, 3, mode)
        c1 = dwt1d(flat, wave, 3, mode)
        assert _rel_err(g1[0].cpu(), c1[0]) <= 1e-5
        r1 = idwt1d(*g1, wave, mode, out_len=flat.shape[-1])
        assert _rel_err(r1.cpu(), idwt1d(*c1, wave, mode, out_len=flat.shape[-1])) <= 1e-5


def _config3_wcfg(**window):
    from sonar_tpu_torch.cfg import WaveletCFG, WCFGRules

    return WaveletCFG(rules=WCFGRules.build(
        wave="db4", level=3, padding_mode="periodization", high_precision_mode=False,
        diff=dict(yl_scale=8.0, yh_scales=[7.0, [6.0, 6.0, 7.0], "fill"],
                  scales_end=dict(yl_scale=6.0, yh_scales=6.0),
                  schedule="half_cosine", schedule_mode="sampling"), **window))


def _wcfg_args(device, sigma, shape=(1, 4, 128, 128)):
    from sonar_tpu_torch.cfg import DiscreteSampling

    g = torch.Generator().manual_seed(5)
    x, c, u = (torch.randn(shape, generator=g) * k for k in (14.6, 1.0, 1.1))
    x, c, u = x.to(device), c.to(device), u.to(device)
    sig = np.asarray([14.6, 9.0, 5.0, 2.0, 0.5, 0.03, 0.0], np.float32)
    return dict(input=x, sigma=torch.full((1,), sigma, device=device), sigma_host=sigma,
                cond=x - c, uncond=x - u, cond_denoised=c, uncond_denoised=u, cond_scale=7.0,
                model_sampling=DiscreteSampling(), sample_sigmas=sig)


@pytest.mark.cuda
@pytest.mark.parametrize("window,sigma", [({}, 14.6), ({}, 0.0), ({}, 2.0),
                                          ({"start_sigma": 9.0, "end_sigma": 1.0}, 9.0),
                                          ({"start_sigma": 9.0, "end_sigma": 1.0}, 14.6)])
def test_wavelet_cfg_on_the_card_matches_the_cpu(cuda, window, sigma):
    wcfg = _config3_wcfg(**window)
    got = wcfg(_wcfg_args(cuda, sigma))
    assert got.is_cuda
    assert _rel_err(got.cpu(), wcfg(_wcfg_args("cpu", sigma))) <= 1e-5


@pytest.mark.cuda
def test_a_guided_call_does_not_synchronise(cuda):
    """A guided call of the config-3 pipeline (UNet pair and wavelet CFG)
    makes no host-device synchronisation: the rule and its percentages are
    chosen on the host sigma the sampler passes beside the batch."""
    from sonar_tpu_torch.api import SonarPipeline
    from sonar_tpu_torch.cfg import DiscreteSampling
    from sonar_tpu_torch.models import UNetConfig, init_unet_params, make_denoiser

    cfg = UNetConfig(model_channels=32, channel_mult=(1, 2), attention_levels=(1,))
    den = make_denoiser(init_unet_params(torch.Generator().manual_seed(0), cfg, device=cuda))
    pipe = SonarPipeline(model=den, model_uncond=lambda x, s, **kw: den(x * 0.97, s),
                         wavelet_cfg=_config3_wcfg(), model_sampling=DiscreteSampling(),
                         sampler="sonar_dpmpp_sde")
    guided = pipe._denoiser(np.asarray([14.6, 5.0, 1.0, 0.0], np.float32))
    x, s_in = torch.randn((1, 4, 64, 64), device=cuda), torch.full((1,), 5.0, device=cuda)
    guided(x, s_in, sigma_host=5.0)  # puts the transform's constants on the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = guided(x, s_in, sigma_host=5.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.is_cuda and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# FreeU-Extreme and the rest of the noise zoo on the card (torch ops and
# kernel B3's draws). FreeU's operators against the FFT, relative to
# max(1, |fft|): dense K 3e-6, the factor pair 3e-5, whatever the global TF32
# switches say; the card's FFT against the CPU's 1e-5. Generators: one seed,
# CPU against card, 1e-5 relative to max(1, |cpu|) (B3's ulps, cuFFT
# against pocketfft).
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hw", [16, 32, 64])
@pytest.mark.parametrize("tf32", [True, False])
def test_freeu_operators_agree_on_the_card(cuda, hw, tf32):
    from sonar_tpu_torch.cfg import ffilter
    from sonar_tpu_torch.noise import PowerFilter

    pf = PowerFilter(alpha=0.4)
    x = torch.randn((1, 96, hw, hw), generator=torch.Generator().manual_seed(hw))
    on_cpu = ffilter(x, pf, 0.25, operator="fft")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        out = {op: ffilter(x.to(cuda), pf, 0.25, operator=op) for op in ("dense", "sep", "fft")}
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    assert all(o.is_cuda for o in out.values())
    assert _rel_err(out["fft"].cpu(), on_cpu) <= 1e-5
    assert _rel_err(out["dense"], out["fft"]) <= 3e-6
    assert _rel_err(out["sep"], out["fft"]) <= 3e-5


@pytest.mark.cuda
def test_a_patched_forward_does_not_synchronise(cuda):
    """FreeU's percent window is a device-side select on the sigma the patch
    sees: a patched forward reads nothing back from the card."""
    from sonar_tpu_torch.cfg import DiscreteSampling, FreeUExtremeConfig, make_freeu_patches
    from sonar_tpu_torch.models import UNetConfig, init_unet_params
    from sonar_tpu_torch.noise import PowerFilter

    cfg = UNetConfig(model_channels=16, channel_mult=(1, 2, 4), attention_levels=(2,))
    model = init_unet_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    frux = FreeUExtremeConfig(target="both", stage_1=True, stage_2=True, scale=1.12, slice=0.75,
                              start=0.1, end=0.9, sonar_power_filter=PowerFilter(alpha=0.4))
    patches = make_freeu_patches(model_sampling=DiscreteSampling(), model_channels=16,
                                 input_config=frux, middle_config=frux, output_config=frux)
    x, s = torch.randn((1, 4, 64, 64), device=cuda), torch.full((1,), 3.0, device=cuda)
    with torch.no_grad():
        model(x, s, block_patches=patches)  # puts the operators and the table on the card
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(x, s, block_patches=patches)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(torch.isfinite(out).all()) and not torch.equal(out, model(x, s))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["perlin", "studentt", "pink_old", "power_old", "laplacian",
                                  "green_test", "onef_pinkish", "onef_greenish",
                                  "onef_pinkishgreenish", "onef_pinkish_mix",
                                  "onef_greenish_mix", "white", "grey", "velvet", "violet",
                                  "rainbow_mild", "rainbow_intense"])
def test_new_generators_draw_the_same_on_cpu_and_card(cuda, name):
    from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler

    out = []
    for where in ("cpu", cuda):
        fn, st = make_noise_sampler(get_noise_item(name), (2, 4, 64, 64), device=where, seed=5)
        out.append(fn(st, 1.0, 0.5)[0])
    assert out[1].is_cuda and _rel_err(out[1].cpu(), out[0]) <= 1e-5


@pytest.mark.cuda
def test_video_noise_draws_the_same_on_cpu_and_card(cuda):
    from sonar_tpu_torch.noise import CustomNoiseParametersNoise, make_noise_sampler
    from sonar_tpu_torch.noise.power import PowerNoiseItem

    out = []
    for where in ("cpu", cuda):
        item = CustomNoiseParametersNoise(
            noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
            frames_to_channels=True)
        fn, st = make_noise_sampler(item, (1, 4, 4, 64, 64), device=where, seed=3,
                                    sigma_min=0.03, sigma_max=14.6)
        a, st = fn(st, 14.0, 9.0)
        b, st = fn(st, 9.0, 4.0)
        out.append(torch.stack([a, b]))
    assert out[1].is_cuda and _rel_err(out[1].cpu(), out[0]) <= 1e-5


# ---------------------------------------------------------------------------
# The sampler registry on the card (torch ops; noise through B2 and B3): a
# narrow UNet on the card against the same weights on the CPU, one injected
# numpy noise stream (or one seed's Philox draws), TF32 off, 1e-4 relative to
# the trajectory's largest magnitude; dpm_adaptive with the same attempts
# and accepted steps on both; no host synchronisation inside a step.
# ---------------------------------------------------------------------------

class _Recorded:
    """A denoiser that records the host sigma of each call (passed beside the
    batch: recording reads nothing back from the card) and, with
    ``sync_check``, turns on the sync check at its first call."""

    takes_sigma_host = True

    def __init__(self, fn, sync_check=False):
        self.fn, self.sigmas, self.sync_check = fn, [], sync_check

    def __call__(self, x, s, *, sigma_host=None, **kw):
        if self.sync_check and not self.sigmas:
            torch.cuda.set_sync_debug_mode("error")
        self.sigmas.append(sigma_host)
        return self.fn(x, s, **kw)


def _registry_pair(device):
    from sonar_tpu_torch.models import UNetConfig, init_unet_params, make_denoiser

    cfg = UNetConfig(model_channels=32, channel_mult=(1, 2), attention_levels=(1,))
    model = init_unet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return make_denoiser(copy.deepcopy(model).to(device)), make_denoiser(model)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["euler_ancestral", "heunpp2", "dpmpp_2m", "dpmpp_2s_ancestral",
                                  "dpmpp_2m_sde", "dpmpp_3m_sde", "res_multistep_ancestral",
                                  "ddpm", "uni_pc", "lms", "dpm_fast", "dpm_adaptive",
                                  "restart"])
def test_registry_sampler_on_the_card_matches_the_cpu(cuda, name):
    import inspect

    from sonar_tpu_torch.api import get_sampler

    torch.backends.cudnn.allow_tf32 = False
    fn = get_sampler(name)
    card_den, cpu_den = _registry_pair(cuda)
    ramp = np.linspace(0, 1, 6)
    sig = np.append((14.6 ** (1 / 7) + ramp * (0.03 ** (1 / 7) - 14.6 ** (1 / 7))) ** 7, 0.0)
    sig = torch.from_numpy(sig.astype(np.float32))
    rng = np.random.default_rng(3)
    draws = [torch.from_numpy(rng.standard_normal((1, 4, 32, 32)).astype(np.float32))
             for _ in range(16)]
    x0 = draws[-1] * 14.6
    out = {}
    for where, den in ((cuda, card_den), ("cpu", cpu_den)):
        # dpm_adaptive with a tight controller, so that it rejects attempts
        kw = dict(seed=7, **(dict(h_init=2.0, rtol=1e-4, atol=1e-5)
                             if name == "dpm_adaptive" else {}))
        if "noise_sampler" in inspect.signature(fn).parameters:
            dev_draws = [d.to(where) for d in draws]
            kw["noise_sampler"] = lambda i, s, sn, _d=dev_draws: _d[i]
        rec = _Recorded(den, sync_check=where == cuda and name != "dpm_adaptive")
        try:
            out[where == cuda] = fn(rec, x0.to(where), sig, **kw), rec.sigmas
        finally:
            torch.cuda.set_sync_debug_mode(0)
    (card, card_calls), (cpu, cpu_calls) = out[True], out[False]
    torch.backends.cudnn.allow_tf32 = True
    assert card.is_cuda and bool(torch.isfinite(card).all())
    assert len(card_calls) == len(cpu_calls)
    if name == "dpm_adaptive":  # the same attempts, the same accepted steps
        assert len(set(card_calls[::3])) == len(set(cpu_calls[::3]))
    assert _rel_err(card.cpu(), cpu) <= 1e-4


# ---------------------------------------------------------------------------
# The combinator algebra on the card (torch ops; noise through B2-B6): each
# of the JAX package's 16 other combinator classes, BlendFilterNoise,
# BlehOpsNoise and WaveletFilteredNoise, one seed, CPU against card, 1e-5
# relative to max(1, |cpu|) (1e-4 where cuFFT meets pocketfft in
# ModulatedNoise's frequency and spectral modes); trees A and B of
# chip_smoke.py [25] under sonar_euler_ancestral with no host
# synchronisation inside a step; the blur and the frequency filter bit for
# bit whatever the TF32 switches say.
# ---------------------------------------------------------------------------


def _combinator_cases():
    from sonar_tpu_torch.cfg.latent_ops import SonarLatentOperationQuantileFilter
    from sonar_tpu_torch.noise import (BlehOpsNoise, BlendedNoise, BlendFilterNoise, ChannelNoise,
                                       CompositeNoise, GuidedNoise, LatentOperationFilteredNoise,
                                       ModulatedNoise, NormalizeToScaleNoise, PatternBreakNoise,
                                       PerDimNoise, QuantileFilteredNoise, RandomNoise,
                                       RepeatedNoise, ResizedNoise, RippleFilteredNoise,
                                       ShuffledNoise, WaveletFilteredNoise, get_noise_item)

    g = get_noise_item
    mask = np.zeros((64, 64), np.float32)
    mask[:, :32] = 1.0
    guide = np.random.default_rng(11).standard_normal((1, 4, 32, 32)).astype(np.float32)
    rules = [{"when": {"sigma_min": 0.5, "sigma_max": 10.0},
              "ops": [["ffilter", {"filter": "highpass", "strength": 0.6}],
                      ["enhance", {"mode": "sharpen", "scale": 0.3}],
                      ["roll", {"dim": -1, "amount": 5}]]}]
    return {
        "composite": (lambda: CompositeNoise(mask=mask, dst_noise=g("gaussian"),
                                             src_noise=g("pyramid")), 1e-5),
        "guided": (lambda: GuidedNoise(ref_latent=guide, noise=g("gaussian")), 1e-5),
        "repeated": (lambda: RepeatedNoise(noise=g("pyramid"), repeat_length=2,
                                           max_recycle=1, permute="always"), 1e-5),
        **{f"modulated_{m}": (lambda _m=m: ModulatedNoise(noise=g("gaussian"),
                                                           modulation_type=_m),
                              1e-5 if m == "intensity" else 1e-4)
           for m in ("intensity", "frequency", "spectral_signum")},
        "random": (lambda: RandomNoise(noise=[g("gaussian"), g("perlin"), g("pyramid")],
                                       mix_count=2), 1e-5),
        "channel": (lambda: ChannelNoise(noise=[g("gaussian"), g("highres_pyramid")]), 1e-5),
        "ripple": (lambda: RippleFilteredNoise(noise=g("gaussian"), roll=2.0), 1e-5),
        "normalize_to_scale": (lambda: NormalizeToScaleNoise(noise=g("gaussian"),
                                                             mode="advanced"), 1e-5),
        "blended": (lambda: BlendedNoise(custom_noise_1=g("gaussian"),
                                         custom_noise_2=g("perlin"),
                                         custom_noise_mask=g("pyramid")), 1e-5),
        "resized": (lambda: ResizedNoise(custom_noise=g("gaussian"), width=256, height=256),
                    1e-5),
        "latent_op": (lambda: LatentOperationFilteredNoise(
            noise=g("gaussian"), operations=[SonarLatentOperationQuantileFilter(
                quantile=0.9, strategy="tanh")]), 1e-5),
        "quantile": (lambda: QuantileFilteredNoise(noise=g("gaussian")), 1e-5),
        "per_dim": (lambda: PerDimNoise(noise=g("pyramid"), dim=1), 1e-5),
        "shuffled": (lambda: ShuffledNoise(noise=g("gaussian"), dims=(1, -1),
                                           percentages=(0.5, 1.0)), 1e-5),
        # uniforms are the same bits on both: pattern_break hashes its input's
        # sixth decimal, so the normals' ulps would come out as other values
        "pattern_break": (lambda: PatternBreakNoise(noise=g("uniform")), 1e-5),
        "blend_filter": (lambda: BlendFilterNoise(
            noise=[g("gaussian"), g("wavelet")], ffilter="highpass", enhance_mode="sharpen",
            affect="both"), 1e-5),
        "bleh_ops": (lambda: BlehOpsNoise(noise=g("gaussian"), rules=rules), 1e-5),
        "wavelet_filtered": (lambda: WaveletFilteredNoise(noise=g("gaussian"),
                                                          noise_high=g("onef_pinkish"),
                                                          wave="db4", level=3), 1e-5),
        "wavelet": (lambda: g("wavelet"), 1e-5),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_combinator_cases()))
def test_combinators_draw_the_same_on_cpu_and_card(cuda, name):
    from sonar_tpu_torch.noise import make_noise_sampler

    make, tol = _combinator_cases()[name]
    ref = _randn((1, 4, 64, 64), "cpu", 4)
    out = []
    for where in ("cpu", cuda):
        fn, st = make_noise_sampler(make(), (1, 4, 64, 64), device=where, seed=5,
                                    ref_latent=ref.to(where))
        draws = []
        for s, sn in ((14.6, 9.0), (9.0, 4.0), (4.0, 1.0)):
            n, st = fn(st, s, sn)
            draws.append(n)
        out.append(torch.stack(draws))
    assert out[1].is_cuda and _rel_err(out[1].cpu(), out[0]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("tree", ["A", "B"])
def test_combinator_trees_do_not_synchronise(cuda, tree):
    from sonar_tpu_torch.noise import (BlehOpsNoise, BlendFilterNoise, ChannelNoise,
                                       CompositeNoise, ModulatedNoise, NormalizeToScaleNoise,
                                       PatternBreakNoise, QuantileFilteredNoise, RepeatedNoise,
                                       RippleFilteredNoise, ShuffledNoise, WaveletFilteredNoise,
                                       get_noise_item as g)
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral

    cases = _combinator_cases()
    if tree == "A":
        mask = np.zeros((32, 32), np.float32)
        mask[:, :16] = 1.0
        item = CompositeNoise(
            mask=mask, dst_noise=RepeatedNoise(noise=g("pyramid"), repeat_length=4,
                                               max_recycle=2),
            src_noise=ModulatedNoise(noise=ChannelNoise(noise=[
                g("gaussian"), g("perlin"), g("highres_pyramid"), g("voronoi_mix")]),
                modulation_type="intensity"))
    else:
        rules = cases["bleh_ops"][0]().rules
        item = PatternBreakNoise(noise=ShuffledNoise(noise=QuantileFilteredNoise(
            noise=NormalizeToScaleNoise(mode="advanced", noise=BlehOpsNoise(
                rules=rules, noise=BlendFilterNoise(noise=[
                    RippleFilteredNoise(noise=g("gaussian")),
                    WaveletFilteredNoise(noise=g("gaussian"), noise_high=g("onef_pinkish"),
                                         wave="db4", level=3),
                    g("wavelet")], ffilter="highpass", enhance_mode="sharpen",
                    affect="both"))))))
    card_den, _ = _registry_pair(cuda)
    sig = torch.tensor([14.6, 6.0, 2.5, 0.9, 0.3, 0.0])
    x0 = _randn((1, 4, 32, 32), cuda, 2) * 14.6
    first = sample_sonar_euler_ancestral(card_den, x0, sig, seed=7, noise_item=item)
    torch.cuda.synchronize()  # the first run puts the constants on the card
    rec = _Recorded(card_den, sync_check=True)
    try:
        again = sample_sonar_euler_ancestral(rec, x0, sig, seed=7, noise_item=item)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(rec.sigmas) == 5 and torch.equal(first, again)
    assert bool(torch.isfinite(again).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 64), (37, 50)])
def test_blur_and_ffilter_are_bit_stable_under_tf32(cuda, hw):
    from sonar_tpu_torch.noise.blendfilter import _sep_blur, ffilter

    x = _randn((2, 4) + hw, cuda, 6)
    outs = []
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        outs.append((_sep_blur(x, 1.0), ffilter(x, 0.2, 0.5, "highpass", 0.7)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert _rel_err(outs[0][0].cpu(), _sep_blur(x.cpu(), 1.0)) <= 1e-5
    assert _rel_err(outs[0][1].cpu(), ffilter(x.cpu(), 0.2, 0.5, "highpass", 0.7)) <= 1e-5


# ---------------------------------------------------------------------------
# the rest of the noise zoo on the card (torch ops and kernel B3's draws):
# the DTCWT (exact float32 whatever the TF32 switches say; reconstruction and
# card vs CPU 1e-5 relative to max(1, |cpu|)), the distributions (one seed,
# CPU vs card: the transforms 1e-5; the rejection samplers' accept decisions
# may differ where B3's normals differ by an ulp, so under 1e-3 of their
# elements may be past 1e-5), Collatz and scatternet noise (1e-5), wavelet CFG
# on the DTCWT (1e-5), and runs under the sync check.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("banks", [("near_sym_a", "qshift_a"), ("legall", "qshift_b"),
                                   ("antonini", "qshift_06"), ("near_sym_b", "qshift_c"),
                                   ("native", "native")])
def test_dtcwt_on_the_card_matches_the_cpu(cuda, banks):
    from sonar_tpu_torch.wavelets import dtcwt2d, idtcwt2d

    biort, qshift = banks
    x = torch.randn((1, 4, 128, 128), generator=torch.Generator().manual_seed(3))
    cl, ch = dtcwt2d(x, 3, biort=biort, qshift=qshift)
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        gl, gh = dtcwt2d(x.to(cuda), 3, biort=biort, qshift=qshift)
        assert gh[0].dtype == torch.complex64 and gh[0].is_cuda
        assert all(_rel_err(g.cpu(), c) <= 1e-5 for g, c in zip(gl, cl))
        assert all(_rel_err(torch.view_as_real(g).cpu(), torch.view_as_real(c)) <= 1e-5
                   for g, c in zip(gh, ch))
        back = idtcwt2d(gl, gh, biort=biort, qshift=qshift)
        assert _rel_err(back.cpu(), x) <= 1e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
@pytest.mark.parametrize("distro", ["normal", "cauchy", "gumbel", "continuous_bernoulli",
                                    "relaxed_onehotcategorical", "studentt", "lrmvariate_normal",
                                    "gamma", "beta", "dirichlet", "poisson", "vonmises",
                                    "wishart", "lkjcholesky", "inverse_gamma"])
def test_distro_draws_on_the_card_match_the_cpu(cuda, distro):
    from sonar_tpu_torch.noise import NoiseCtx
    from sonar_tpu_torch.noise.distro import REJECTION, DistroGenerator

    gen = DistroGenerator(distro=distro, poisson_rate="30.0")
    cpu = gen.raw(NoiseCtx((1, 4, 64, 64), device="cpu"), 11).double()
    card = gen.raw(NoiseCtx((1, 4, 64, 64), device=cuda), 11)
    assert card.is_cuda and card.shape == cpu.shape and bool(torch.isfinite(card).all())
    off = ((card.cpu().double() - cpu).abs() > 1e-5 * cpu.abs().clamp(min=1.0)).double().mean()
    assert float(off) <= (1e-3 if distro in REJECTION else 0.0), float(off)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("distro", {}), ("distro", {"distro": "laplacian"}),
                                     ("collatz", {}),
                                     ("collatz", {"output_mode": "noise_x_adds",
                                                  "flatten": True, "dims": (1,)})])
def test_new_zoo_names_draw_the_same_on_cpu_and_card(cuda, name, kw):
    from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler

    out = []
    for where in ("cpu", cuda):
        fn, st = make_noise_sampler(get_noise_item(name, **kw), (1, 4, 64, 64), device=where,
                                    seed=5)
        n, st = fn(st, 14.6, 9.0)
        out.append(n)
    assert out[1].is_cuda and _rel_err(out[1].cpu(), out[0]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"wavelet_backend": "dwt"}, {"scatternet_order": 2},
                                {"scatternet_order": 2, "wavelet_backend": "dwt",
                                 "output_mode": "flat"}])
def test_scatternet_on_the_card_matches_the_cpu(cuda, kw):
    from sonar_tpu_torch.noise import ScatternetFilteredNoise, get_noise_item, make_noise_sampler

    out = []
    for where in ("cpu", cuda):
        fn, st = make_noise_sampler(ScatternetFilteredNoise(noise=get_noise_item("gaussian"), **kw),
                                    (1, 4, 64, 64), device=where, seed=5)
        n, st = fn(st, 14.6, 9.0)
        out.append(n)
    assert out[1].is_cuda and _rel_err(out[1].cpu(), out[0]) <= 1e-5


def _dtcwt_wcfg():
    from sonar_tpu_torch.cfg import WaveletCFG, WCFGRules

    return WaveletCFG(rules=WCFGRules.build(
        level=3, use_dtcwt=True, high_precision_mode=False,
        diff=dict(yl_scale=8.0, yh_scales=[7.0, [6.0, 6.0, 7.0, 6.5], "fill"],
                  scales_end=dict(yl_scale=6.0, yh_scales=6.0),
                  schedule="half_cosine", schedule_mode="sampling")))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [14.6, 2.0])
def test_dtcwt_wavelet_cfg_on_the_card_matches_the_cpu(cuda, sigma):
    wcfg, args = _dtcwt_wcfg(), _wcfg_args(cuda, sigma)
    got = wcfg(args)
    assert got.is_cuda and _rel_err(got.cpu(), wcfg(_wcfg_args("cpu", sigma))) <= 1e-5
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = wcfg(args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("distro", {}), ("distro", {"distro": "gamma"}),
                                     ("distro", {"distro": "poisson", "poisson_rate": "20.0"}),
                                     ("collatz", {}), ("scatternet", {})])
def test_new_zoo_noise_does_not_synchronise(cuda, name, kw):
    from sonar_tpu_torch.noise import ScatternetFilteredNoise, get_noise_item
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral

    item = (ScatternetFilteredNoise(noise=get_noise_item("gaussian")) if name == "scatternet"
            else get_noise_item(name, **kw))
    card_den, _ = _registry_pair(cuda)
    sig = torch.tensor([14.6, 6.0, 2.5, 0.9, 0.3, 0.0])
    x0 = _randn((1, 4, 32, 32), cuda, 2) * 14.6
    first = sample_sonar_euler_ancestral(card_den, x0, sig, seed=7, noise_item=item)
    torch.cuda.synchronize()  # the first run puts the transforms' constants on the card
    rec = _Recorded(card_den, sync_check=True)
    try:
        again = sample_sonar_euler_ancestral(rec, x0, sig, seed=7, noise_item=item)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(rec.sigmas) == 5 and torch.equal(first, again)
    assert bool(torch.isfinite(again).all())


# -- the sharded entries (the parallel tier): B3 and B4 at a shard's indices, B2 split --


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", [(16384, 16384, 32768), (5, 4099, 8198), (3, 7, 9)])
def test_philox_shard_is_the_unsharded_slice(cuda, shard, dtype):
    """A shard's draw: uniforms bit for bit against the plain version and the
    unsharded kernel draw's slice; normals 2e-6 against plain, bit-equal to
    the unsharded kernel's (the same device functions on the same words).
    Aligned slices and slices that start and end inside a Philox group."""
    first, run, stride = shard
    n = 2 * run
    idx = H.shard_indices(n, shard, device=cuda)
    full = first + stride + run
    u = H.philox_rand(3, (n,), device=cuda, dtype=dtype, shard=shard)
    assert torch.equal(u, H.philox_rand_reference(3, (n,), device=cuda, dtype=dtype,
                                                  shard=shard))
    assert torch.equal(u, H.philox_rand(3, (full,), device=cuda, dtype=dtype)[idx])
    z = H.philox_randn(3, (n,), device=cuda, shard=shard)
    zr = H.philox_randn_reference(3, (n,), device=cuda, shard=shard)
    assert float((z - zr).abs().max()) <= 2e-6
    assert torch.equal(z, H.philox_randn(3, (full,), device=cuda)[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,planes", [((1, 4, 64, 64), (4, 4, 8)),
                                          ((1, 3, 67, 61), (1, 1, 2))])
def test_pyramid_plane_slice_matches_plain(cuda, shape, planes):
    """B4 with its base pair drawn at a plane slice's global indices (whole
    Philox groups, and planes of 67 × 61 that start inside one)."""
    ladder = _size_ladder_pyramid(shape[2], shape[3], 10, 0)
    k = P.fused_pyramid(5, shape, ladder, 0.7, device=cuda, planes=planes)
    p = P.fused_pyramid_reference(5, shape, ladder, 0.7, device=cuda, planes=planes)
    assert _rel_err(k, p) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("mode", ["bilinear", "nearest-exact"])
@pytest.mark.parametrize("shape,planes", [((1, 4, 64, 64), (4, 4, 8)),
                                          ((1, 3, 67, 61), (1, 1, 2))])
def test_downscale_plane_slice_matches_plain(cuda, shape, planes, mode, variant):
    """B5 (both kernels) with its fields drawn at a plane slice's global
    indices: against its plain version (1e-5) and bit for bit against the
    unsharded kernel draw's planes (whole Philox groups, and planes of
    67 × 61 that start inside one)."""
    h, w = shape[2:]
    ladder = (_size_ladder_highres(h, w, 4, 0) if mode == "bilinear"
              else [(h * 2 ** (i + 1), w * 2 ** (i + 1)) for i in range(3)])
    coefs = [0.7**i for i in range(len(ladder))]
    i = torch.arange(shape[1], device=cuda)
    idx = planes[0] + (i // planes[1]) * planes[2] + i % planes[1]
    full_shape = (1, int(idx.max()) + 1, h, w)
    base = _randn(full_shape, cuda) if mode == "bilinear" else None
    local_base = None if base is None else base[:, idx].contiguous()
    with P._forced_down_variant(variant):
        k = P.fused_downscale_pyramid(5, shape, ladder, coefs, mode, base=local_base,
                                      device=cuda, planes=planes)
        full = P.fused_downscale_pyramid(5, full_shape, ladder, coefs, mode, base=base,
                                         device=cuda)
    p = P.fused_downscale_pyramid_reference(5, shape, ladder, coefs, mode, local_base,
                                            device=cuda, planes=planes)
    assert _rel_err(k, p) <= 1e-5
    assert torch.equal(k, full[:, idx])
    with pytest.raises(ValueError, match="whole runs"):
        P.fused_downscale_pyramid(5, shape, ladder, coefs, mode, base=local_base, device=cuda,
                                  planes=(0, 2, 4) if shape[1] % 2 else (0, 3, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (1, 3, 67, 61)])
def test_scale_noise_split_matches_plain(cuda, shape, dtype):
    """B2 split: the moments, the squared deviations about the (reduced)
    mean and the affine against their plain versions, 1e-5 (bf16: one ulp);
    on one shard standing for the whole latent it is B2's result."""
    x = (_randn(shape, cuda) * 1.7 + 0.3).to(dtype)
    mo = F.scale_noise_moments(x)
    assert _rel_err(mo, F.scale_noise_moments_reference(x)) <= 1e-5
    m2 = F.scale_noise_m2(x, mo)
    assert _rel_err(m2, F.scale_noise_m2_reference(x, mo)) <= 1e-5
    out = F.scale_noise_apply(x, mo, m2, 1.5)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    assert _rel_err(out.float(), F.scale_noise_apply_reference(x, mo, m2, 1.5).float()) <= tol
    assert _rel_err(out.float(), F.fused_scale_noise(x, 1.5).float()) <= tol
