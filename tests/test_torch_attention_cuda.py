"""Kernel B7 (``csrc/attention.cu``) on the card.

These tests need an NVIDIA GPU with ``nvcc`` and skip without one. They
import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_cuda.py -q

Each instantiation is held against a float64 reference at the main path's
shapes (SD v1's UNet: 16,384 × 8 heads × 40, 4,096 × 80, 1,024 × 160 and
256 × 160 with TF32 off; DiT-XL/2: 8 × 1,024 × 16 heads × 72 with TF32 on;
FLUX.1-dev: 4,608 × 24 heads × 128 with TF32 on, and off),
at ragged token counts (40, 200, 257, 333, 1,000), on a qkv that is not
contiguous and on bf16 and fp16 qkv, at 512 sampled query rows; which tile
each call took (``wgmma``, ``mma.sync`` or FFMA) is read from the
wrapper's counters. The error is the largest
absolute difference over the reference's RMS, and the kernel's may be at
most twice that of the operator path (the plain version, run on the card
under the same TF32 setting and in the same type): both round the
products and the softmax in float32 (TF32 on: q, k, the probabilities and
v to TF32), in other orders; in bf16 and fp16 the operators also round
their products and the probabilities to that type, the kernel only its
output. The models launch it once per attention block (16 in SD v1's UNet,
28 in DiT-XL/2), under autograd too, where the gradients are the
operators' recomputed from qkv.
"""

import dataclasses
import math

import pytest
import torch

import sonar_tpu_torch.models.dit as D
from sonar_tpu_torch.kernels import attention as A
from sonar_tpu_torch.models.dit import DiTConfig, init_dit_params
from sonar_tpu_torch.models.unet import UNetConfig, init_unet_params
from sonar_tpu_torch.utils import profiling


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _qkv(layout, b, n, heads, d, *, scale=1.0, seed=0, offset=None, dtype=torch.float32):
    """Random qkv; with ``offset``, rows of a wider tensor starting that many
    elements in (1: no 16-byte copies)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    width = 3 * heads * d
    if offset is None:
        x = torch.randn((b, n, width), generator=g, device="cuda") * scale
    else:
        x = torch.randn((b, n, width + 24), generator=g, device="cuda") * scale
        x = x[..., offset:offset + width]
    x = x.to(dtype)
    return x.unflatten(-1, (3, heads, d) if layout == "unet" else (heads, 3, d))


def _reference64(qkv, layout, rows):
    q, k, v = (qkv.double().select(2 if layout == "unet" else 3, i) for i in range(3))
    q = q[:, rows]
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(q.shape[-1])
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v)
    return out.reshape(q.shape[0], len(rows), -1)


def _error(out, ref):
    return float((out.double() - ref).abs().max() / ref.square().mean().sqrt())


CASES = {
    "sd1 level 0, 16384 x 8 x 40": ("unet", 1, 16384, 8, 40, False, {}),
    "sd1 level 1, 4096 x 8 x 80": ("unet", 1, 4096, 8, 80, False, {}),
    "sd1 level 2, 1024 x 8 x 160": ("unet", 1, 1024, 8, 160, False, {}),
    "sd1 middle, 256 x 8 x 160": ("unet", 1, 256, 8, 160, False, {}),
    "dit-xl2, 8 x 1024 x 16 x 72": ("dit", 8, 1024, 16, 72, True, {}),
    "ragged 257 x 8 x 40": ("unet", 1, 257, 8, 40, False, {}),
    "ragged 1000 x 16 x 72, tf32": ("dit", 2, 1000, 16, 72, True, {}),
    "ragged 1000 x 4 x 64": ("dit", 2, 1000, 4, 64, False, {}),
    "not contiguous, 500 x 8 x 40": ("unet", 1, 500, 8, 40, False, {"offset": 8}),
    "not contiguous, 500 x 16 x 72, tf32": ("dit", 1, 500, 16, 72, True, {"offset": 8}),
    "misaligned, 500 x 8 x 40": ("unet", 1, 500, 8, 40, False, {"offset": 1}),
    "misaligned, 500 x 16 x 72, tf32": ("dit", 2, 500, 16, 72, True, {"offset": 1}),
    "odd width 37": ("unet", 1, 300, 2, 37, False, {}),
    "odd width 37, tf32": ("unet", 1, 300, 2, 37, True, {}),
    "peaked logits, 4096 x 8 x 40": ("unet", 1, 4096, 8, 40, False, {"scale": 3.0}),
    "peaked logits, 8 x 1024 x 16 x 72, tf32": ("dit", 8, 1024, 16, 72, True, {"scale": 3.0}),
    "padded width 8 -> 40": ("unet", 2, 300, 2, 8, False, {}),
    "padded width 200 -> 256": ("unet", 1, 300, 2, 200, False, {}),
    "padded width 200 -> 256, tf32": ("unet", 1, 300, 2, 200, True, {}),
    "width 80, tf32": ("unet", 1, 777, 2, 80, True, {}),
    "width 160, tf32": ("unet", 1, 777, 2, 160, True, {}),
    "bf16, 4096 x 8 x 40": ("unet", 1, 4096, 8, 40, False, {"dtype": torch.bfloat16}),
    "bf16, 2 x 1024 x 6 x 64": ("dit", 2, 1024, 6, 64, False, {"dtype": torch.bfloat16}),
    "bf16, 2 x 1024 x 6 x 64, tf32": ("dit", 2, 1024, 6, 64, True, {"dtype": torch.bfloat16}),
    "fp16, 1000 x 8 x 80": ("unet", 1, 1000, 8, 80, False, {"dtype": torch.float16}),
    "fp16 misaligned, 500 x 16 x 72, tf32": ("dit", 2, 500, 16, 72, True,
                                             {"dtype": torch.float16, "offset": 1}),
    "bf16 ragged, 257 x 2 x 160": ("unet", 1, 257, 2, 160, False, {"dtype": torch.bfloat16}),
    "flux1-dev, 4608 x 24 x 128, tf32": ("unet", 1, 4608, 24, 128, True, {}),
    "width 128, 4608 x 24 x 128": ("unet", 1, 4608, 24, 128, False, {}),
    "ragged 1000 x 4 x 128, tf32": ("unet", 2, 1000, 4, 128, True, {}),
    "misaligned, 500 x 4 x 128, tf32": ("unet", 1, 500, 4, 128, True, {"offset": 1}),
    "padded width 96 -> 128": ("unet", 1, 300, 2, 96, False, {}),
    "bf16, 1000 x 4 x 128, tf32": ("unet", 1, 1000, 4, 128, True, {"dtype": torch.bfloat16}),
    # the wgmma tile: token counts no multiple of its 128 query rows or 64
    # keys (one partial key tile, one partial query block), several planes
    "wgmma ragged 333, 3 x 333 x 5 x 128": ("dit", 3, 333, 5, 128, True, {}),
    "wgmma ragged 200 x 2 x 72": ("dit", 1, 200, 2, 72, True, {}),
    "wgmma ragged 40 x 2 x 72": ("dit", 1, 40, 2, 72, True, {}),
    "wgmma planes, 4 x 1000 x 6 x 128": ("unet", 4, 1000, 6, 128, True, {}),
    "wgmma bf16, 2 x 1024 x 16 x 72": ("dit", 2, 1024, 16, 72, True, {"dtype": torch.bfloat16}),
    "wgmma padded width 100 -> 128": ("unet", 1, 300, 2, 100, True, {}),
    "wgmma peaked logits, 1000 x 4 x 128": ("unet", 1, 1000, 4, 128, True, {"scale": 3.0}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_against_float64(cuda, case):
    layout, b, n, heads, d, tf32, kw = CASES[case]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    qkv = _qkv(layout, b, n, heads, d, **kw)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(n))[:512].sort().values
    rows = rows.to(cuda)
    ref = _reference64(qkv, layout, rows)
    before = A.fused_attention.launches
    out = A.fused_attention(qkv, layout)
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before + 1
    assert out.shape == (b, n, heads * d) and out.dtype == qkv.dtype
    assert torch.isfinite(out).all()
    ops = A.attention_reference(qkv, layout)
    err, err_ops = _error(out[:, rows], ref), _error(ops[:, rows], ref)
    assert err <= 2 * err_ops, (err, err_ops)


# the tile each case runs on (``kernels/attention.py b7_tile``), read from
# ``fused_attention.wgmma_launches``
TILE_OF = {
    "dit-xl2, 8 x 1024 x 16 x 72": "wgmma",
    "flux1-dev, 4608 x 24 x 128, tf32": "wgmma",
    "ragged 1000 x 16 x 72, tf32": "wgmma",
    "not contiguous, 500 x 16 x 72, tf32": "wgmma",  # rows 8 floats in: 16-byte copies
    "bf16, 1000 x 4 x 128, tf32": "wgmma",  # widened: a fresh float32 copy
    "wgmma ragged 200 x 2 x 72": "wgmma",
    "wgmma padded width 100 -> 128": "wgmma",
    "misaligned, 500 x 16 x 72, tf32": "mma",
    "misaligned, 500 x 4 x 128, tf32": "mma",
    "width 160, tf32": "mma",
    "padded width 200 -> 256, tf32": "mma",
    "width 80, tf32": "mma",
    "bf16, 2 x 1024 x 6 x 64, tf32": "mma",
    "width 128, 4608 x 24 x 128": "ffma",
    "sd1 level 0, 16384 x 8 x 40": "ffma",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_OF))
def test_tile_each_case_takes(cuda, case):
    layout, b, n, heads, d, tf32, kw = CASES[case]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    qkv = _qkv(layout, b, n, heads, d, **kw)
    launches, wgmma = A.fused_attention.launches, A.fused_attention.wgmma_launches
    A.fused_attention(qkv, layout)
    torch.cuda.synchronize()
    assert A.fused_attention.launches == launches + 1
    assert A.fused_attention.wgmma_launches == wgmma + (TILE_OF[case] == "wgmma")


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    qkv = _qkv("unet", 1, 64, 2, 40)
    before = A.fused_attention.launches
    with pytest.raises(TypeError):
        A.fused_attention(qkv.double(), "unet")
    with pytest.raises(TypeError):
        A.fused_attention(qkv.double().requires_grad_(), "unet")
    with pytest.raises(ValueError):
        A.fused_attention(_qkv("unet", 1, 8, 1, 260), "unet")
    with pytest.raises(ValueError):
        A.fused_attention(qkv.transpose(-1, -2), "unet")
    assert A.fused_attention.launches == before


SD1 = UNetConfig(model_channels=64, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                 attention_levels=(0, 1, 2), num_heads=8, norm_groups=32)  # SD v1's layout
DIT = DiTConfig(hidden=256, depth=28, num_heads=16)  # DiT-XL/2's depth and heads


def _net(family, cuda, dtype=torch.float32):
    if family == "unet":
        cfg = dataclasses.replace(SD1, dtype=dtype)
        net = init_unet_params(torch.Generator().manual_seed(0), cfg, device=cuda)
        x = torch.randn(1, 4, 64, 64, device=cuda)
    else:
        cfg = dataclasses.replace(DIT, dtype=dtype)
        net = init_dit_params(torch.Generator().manual_seed(0), cfg, device=cuda)
        x = torch.randn(2, 4, 32, 32, device=cuda)
    return net, x, torch.full((x.shape[0],), 3.0, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("family, blocks", [("unet", 16), ("dit", 28)])
def test_launches_per_forward(cuda, family, blocks):
    """One launch per attention block and per ``sonar.attention`` span: in
    float32 and bf16 without autograd, and in a forward under autograd
    (whose backward launches nothing)."""
    net, x, sigma = _net(family, cuda)
    with torch.no_grad():
        net(x, sigma)
        before = A.fused_attention.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.reset_spans()
            net(x, sigma)
            spans = profiling.span_totals()
    assert A.fused_attention.launches == before + blocks
    assert spans["sonar.attention"]["count"] == blocks

    before = A.fused_attention.launches
    out = net(x, sigma)
    assert A.fused_attention.launches == before + blocks
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before + blocks
    profiling.reset_spans()

    net, x, sigma = _net(family, cuda, torch.bfloat16)
    before = A.fused_attention.launches
    with torch.no_grad():
        out = net(x, sigma)
    assert A.fused_attention.launches == before + blocks and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["unet", "dit"])
def test_forward_against_the_operators(cuda, family, monkeypatch):
    """A whole forward with the kernel against the same with the operators
    on the card, TF32 off for the products and cuDNN's convolutions alike,
    1e-4 relative to the output's largest magnitude."""
    import sonar_tpu_torch.models.unet as U

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net, x, sigma = _net(family, cuda)
    with torch.no_grad():
        got = net(x, sigma)
        monkeypatch.setattr(U, "fused_attention", A.attention_reference)
        monkeypatch.setattr(D, "fused_attention", A.attention_reference)
        want = net(x, sigma)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["unet", "dit"])
def test_gradients_against_the_operators(cuda, family, monkeypatch):
    """A forward and backward with the kernel (the backward the operators'
    graph recomputed from qkv) against the same with the operators alone,
    TF32 off: every parameter's gradient within 1e-3 of the largest
    magnitude of the operators' gradient of that parameter."""
    import sonar_tpu_torch.models.unet as U

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.backends.cuda.matmul.allow_tf32 = False
    net, x, sigma = _net(family, cuda)

    def grads():
        net.zero_grad()
        net(x, sigma).square().mean().backward()
        return [p.grad.clone() for p in net.parameters()]

    before = A.fused_attention.launches
    got = grads()
    assert A.fused_attention.launches > before
    monkeypatch.setattr(U, "fused_attention", A.attention_reference)
    monkeypatch.setattr(D, "fused_attention", A.attention_reference)
    want = grads()
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(got, want))
    assert worst <= 1e-3, worst
