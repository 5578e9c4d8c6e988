"""FLUX.1 (``sonar_tpu_torch/models/flux.py``) on the card, at FLUX.1-dev's
depth (19 double and 38 single blocks) and head width (128) with two heads.

These tests need an NVIDIA GPU with ``nvcc`` and skip without one. They
import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flux_cuda.py -q

A forward launches kernel B7 once per block, at its 128-wide instance (with
TF32 on, its wgmma tile), inside one ``sonar.attention`` span, with one
``sonar.rope`` span a block; its
output equals the same forward with the operators in B7's place (TF32 off)
within 1e-4 of the output's largest magnitude.
"""

import dataclasses

import pytest
import torch

import sonar_tpu_torch.models.flux as FX
from sonar_tpu_torch.kernels import attention as A
from sonar_tpu_torch.models import FluxConfig, init_flux_params
from sonar_tpu_torch.utils import profiling

CFG = dataclasses.replace(FluxConfig(), hidden_size=256, num_heads=2, context_in_dim=64,
                          vec_in_dim=32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _net(cuda):
    net = init_flux_params(torch.Generator().manual_seed(0), CFG, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, 16, 32, 32), generator=g, device=cuda)
    kw = dict(context=torch.randn((1, 40, 64), generator=g, device=cuda),
              y=torch.randn((1, 32), generator=g, device=cuda),
              guidance=torch.full((1,), 3.5, device=cuda))
    return net, x, torch.full((1,), 0.7, device=cuda), kw


@pytest.mark.cuda
def test_launches_and_spans_per_forward(cuda):
    net, x, t, kw = _net(cuda)
    blocks = CFG.depth + CFG.depth_single_blocks
    assert A.kernel_width(CFG.head_dim) == 128
    with torch.no_grad():
        net(x, t, **kw)
        before = A.fused_attention.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.reset_spans()
            out = net(x, t, **kw)
            spans = profiling.span_totals()
    assert A.fused_attention.launches == before + blocks
    assert spans["sonar.attention"]["count"] == blocks == spans["sonar.rope"]["count"]
    assert spans["sonar.flux.double"]["count"] == CFG.depth
    assert spans["sonar.flux.single"]["count"] == CFG.depth_single_blocks
    assert torch.isfinite(out).all()
    profiling.reset_spans()


@pytest.mark.cuda
def test_tf32_forward_takes_the_wgmma_tile(cuda):
    """With matmul TF32 on, as FLUX.1-dev's cell runs, every block's launch
    takes B7's wgmma tile: the joint qkv and a single block's view into its
    input projection are both 16-byte aligned."""
    net, x, t, kw = _net(cuda)
    blocks = CFG.depth + CFG.depth_single_blocks
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.no_grad():
        launches, wgmma = A.fused_attention.launches, A.fused_attention.wgmma_launches
        out = net(x, t, **kw)
    assert A.fused_attention.launches - launches == blocks
    assert A.fused_attention.wgmma_launches - wgmma == blocks
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_forward_against_the_operators(cuda, tf32, monkeypatch):
    """B7 against the operators under the same TF32 setting: off, 1e-4 of
    the output's largest magnitude; on, both round to TF32 in their own
    orders through 57 blocks, 1e-2."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    net, x, t, kw = _net(cuda)
    with torch.no_grad():
        got = net(x, t, **kw)
        monkeypatch.setattr(FX, "fused_attention", A.attention_reference)
        want = net(x, t, **kw)
    tol = 1e-2 if tf32 else 1e-4
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
