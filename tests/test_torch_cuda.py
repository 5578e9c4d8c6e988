"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels) and
skip without one. They import nothing of JAX, so the card's machine runs
them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: B1 1e-6 relative to max(1, |plain|) (elementwise, same order of
operations, no FMA contraction); B2 1e-5 (its mean and std sum in another
order than torch's reductions); B3 uniforms bit for bit and normals 2e-6
absolute (the card's libdevice logf/cosf/sinf against the host's, a few
ulps of values up to ~5.7); B4 and B5 1e-5 relative to max(1, |plain|)
(B4's products sum in another order; B5 inherits B3's ulps), with matmul
TF32 off for the plain versions.
"""

import pytest
import torch

import sonar_tpu_torch.kernels.fused as F
import sonar_tpu_torch.kernels.fused_pyramid as P
from sonar_tpu_torch.kernels import hwrng as H
from sonar_tpu_torch.noise.generators import _size_ladder_highres, _size_ladder_pyramid

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


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(TypeError):
        F.fused_scale_noise(torch.zeros((1, 4, 8, 8), device=cuda, dtype=torch.float16))
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


def _pyramid_case(hw):
    return hw, _size_ladder_pyramid(*hw, 10, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", P.UP_MODES)
@pytest.mark.parametrize("hw", [(64, 64), (67, 61), (512, 512)])
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
