"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels) and
skip without one. They import nothing of JAX, so the card's machine runs
them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: B1 1e-6 relative to max(1, |plain|) (elementwise, same order of
operations, no FMA contraction); B2 1e-5 (its mean and std sum in another
order than torch's reductions).
"""

import pytest
import torch

import sonar_tpu_torch.kernels.fused as F

GATES = [(h, i, w, 0.5) for h in (0.0, 1.0) for i in (0.0, 1.0) for w in (0.0, 1.0)]
GATES.append((1.0, 1.0, 1.0, 0.0))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
