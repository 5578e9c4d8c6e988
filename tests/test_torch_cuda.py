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
"""

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
    with pytest.raises(TypeError):  # mixed dtypes
        z = torch.zeros((1, 4, 8, 8), device=cuda)
        F.fused_momentum_step(z, z, z, z.half(), F.pack_momentum_scalars(
            sigma=1.0, dt=-0.5, momentum=0.9, hd_ratio=0.75, hd_scale=1.0, md_scale=1.0,
            has=0.0, noise_scale=0.0, device=cuda))
    with pytest.raises(ValueError):
        F.fused_scale_noise(torch.zeros((1, 4, 8, 8), device=cuda).transpose(2, 3))
    x = torch.zeros((1, 4, 8, 8), device=cuda)
    scal = F.pack_momentum_scalars(sigma=1.0, dt=-0.5, momentum=0.9, hd_ratio=0.75,
                                   hd_scale=1.0, md_scale=1.0, has=0.0, noise_scale=0.0)
    with pytest.raises(ValueError):  # scalars left on the host
        F.fused_momentum_step(x, x, x, x, scal)
    with pytest.raises(ValueError):  # mismatched shapes
        F.fused_momentum_step(x, x, x, x[..., :4].contiguous(), scal.to(cuda))


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
