"""The attention core (``sonar_tpu_torch/kernels/attention.py``, kernel B7)
on the CPU.

- The plain version equals the models' operator expressions as they stood
  before the kernel, bit for bit, in both packings, at every head width the
  kernel instantiates and at a token count that is no multiple of a tile.
- The one entry point's choice (``fused_attention``): a CPU tensor takes
  the plain version; a CUDA tensor takes the kernel in float32, bf16 and
  fp16, through the autograd function where autograd records (held here on
  a stand-in tensor: this machine has no card). Under autograd the
  backward is the plain version's, recomputed from ``qkv`` (held here with
  the launch replaced by the plain version).
- UNet and DiT forwards on the CPU are bit-equal to the same forwards with
  the operator expressions inlined as they were, in float32 and bf16, and
  launch nothing.
- What the wrapper refuses, the head width each ``d`` runs on, and the
  build's per-source flags.

The kernel itself is held against float64 on the card
(``tests/test_torch_attention_cuda.py``).
"""

import math
import pathlib
from types import SimpleNamespace

import pytest
import torch

import sonar_tpu_torch.models.unet as U
from sonar_tpu_torch.kernels import _build
from sonar_tpu_torch.kernels import attention as A
from sonar_tpu_torch.models.dit import Block, DiTConfig, init_dit_params
from sonar_tpu_torch.models.unet import UNetConfig, init_unet_params
from sonar_tpu_torch.utils import profiling

WIDTHS = (40, 64, 72, 80, 128, 160)


def _unet_operators(q, k, v, dtype):
    """``models/unet.py Attention.forward``'s expression before the kernel."""
    b, n, heads, d = q.shape
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
    attn = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, heads * d)


def _dit_operators(qkv, dtype):
    """``models/dit.py Block.attention``'s expression before the kernel."""
    b, n, heads, _, dh = qkv.shape
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    att = torch.softmax(logits / math.sqrt(dh), dim=-1)
    out = torch.matmul(att.to(dtype), v)
    return out.transpose(1, 2).reshape(b, n, heads * dh)


def _old_unet_forward(self, x):
    b, c, h, w = x.shape
    n, heads = h * w, self.num_heads
    y = self.norm(x).reshape(b, c, n).transpose(1, 2)
    q, k, v = self.qkv(y).reshape(b, n, 3, heads, c // heads).unbind(2)
    out = _unet_operators(q, k, v, x.dtype)
    return x + self.proj(out).transpose(1, 2).reshape(b, c, h, w)


def _old_dit_attention(self, x):
    b, n, d = x.shape
    dh = d // self.cfg.num_heads
    qkv = self._column(self.qkv, x)
    heads = qkv.shape[-1] // (3 * dh)
    qkv = qkv.reshape(b, n, heads, 3, dh)
    return self._row(self.attn_out, _dit_operators(qkv, x.dtype))


def _qkv(layout, b, n, heads, d, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, n, 3 * heads * d), generator=g).to(dtype)
    return x.view(b, n, 3, heads, d) if layout == "unet" else x.view(b, n, heads, 3, d)


@pytest.mark.parametrize("n", [64, 37])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("layout", ["unet", "dit"])
def test_plain_version_is_the_operators(layout, d, n):
    qkv = _qkv(layout, 2, n, 2, d)
    got = A.attention_reference(qkv, layout)
    want = (_unet_operators(*qkv.unbind(2), qkv.dtype) if layout == "unet"
            else _dit_operators(qkv, qkv.dtype))
    assert got.shape == (2, n, 2 * d)
    assert torch.equal(got, want)
    assert torch.equal(A.fused_attention(qkv, layout), want)  # a CPU tensor: the plain version


@pytest.mark.parametrize("layout", ["unet", "dit"])
def test_plain_version_bf16_is_the_operators(layout):
    qkv = _qkv(layout, 1, 50, 2, 40, dtype=torch.bfloat16)
    got = A.attention_reference(qkv, layout)
    want = (_unet_operators(*qkv.unbind(2), qkv.dtype) if layout == "unet"
            else _dit_operators(qkv, qkv.dtype))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _stand_in(dtype=torch.float32, requires_grad=False):
    """What ``fused_attention`` reads of a tensor on the card."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                           requires_grad=requires_grad)


def _route(monkeypatch, qkv, grad=True):
    took = []
    monkeypatch.setattr(A, "_launch", lambda t, layout: took.append("kernel"))
    monkeypatch.setattr(A._Attention, "apply", lambda t, layout: took.append("kernel, autograd"))
    monkeypatch.setattr(A, "attention_reference", lambda t, layout: took.append("operators"))
    with torch.set_grad_enabled(grad):
        A.fused_attention(qkv, "unet")
    return took


@pytest.mark.parametrize("case, want", [
    ("float32, no grad", "kernel"),
    ("float32 requiring grad, grad off", "kernel"),
    ("float32 requiring grad, grad on", "kernel, autograd"),
    ("bf16", "kernel"),
    ("fp16", "kernel"),
    ("bf16 requiring grad, grad on", "kernel, autograd"),
])
def test_models_route_the_card(monkeypatch, case, want):
    qkv = {"float32, no grad": _stand_in(),
           "float32 requiring grad, grad off": _stand_in(requires_grad=True),
           "float32 requiring grad, grad on": _stand_in(requires_grad=True),
           "bf16": _stand_in(torch.bfloat16),
           "fp16": _stand_in(torch.float16),
           "bf16 requiring grad, grad on": _stand_in(torch.bfloat16, requires_grad=True)}[case]
    assert _route(monkeypatch, qkv, grad=case != "float32 requiring grad, grad off") == [want]


@pytest.mark.parametrize("grad", [False, True])
def test_models_route_the_cpu_to_the_operators(monkeypatch, grad):
    qkv = _qkv("unet", 1, 8, 2, 8).requires_grad_(grad)
    assert _route(monkeypatch, qkv, grad=grad) == ["operators"]


@pytest.mark.parametrize("layout", ["unet", "dit"])
def test_meta_tensor_takes_the_plain_version(layout):
    """FLOP counting runs the models on ``meta`` tensors."""
    out = A.fused_attention(_qkv(layout, 1, 8, 2, 8).to("meta"), layout)
    assert out.device.type == "meta" and out.shape == (1, 8, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["unet", "dit"])
def test_autograd_function_backward_is_the_operators(monkeypatch, layout, dtype):
    """``_Attention`` with the launch replaced by the plain version: its
    output and its gradient equal the plain version's own, bit for bit."""
    monkeypatch.setattr(A, "_launch", A.attention_reference)
    qkv = _qkv(layout, 2, 37, 2, 40, dtype=dtype)
    w = torch.randn(2, 37, 80, generator=torch.Generator().manual_seed(3)).to(dtype)
    x1, x2 = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    out1 = A._Attention.apply(x1, layout)
    (out1 * w).sum().backward()
    out2 = A.attention_reference(x2, layout)
    (out2 * w).sum().backward()
    assert torch.equal(out1, out2)
    assert torch.equal(x1.grad, x2.grad)


SMALL_UNET = UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                        attention_levels=(0, 1), num_heads=2, norm_groups=8)
SMALL_DIT = DiTConfig(hidden=64, depth=2, num_heads=4)


def _blocks(net, kind):
    return sum(1 for m in net.modules() if type(m).__name__ == kind)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("family", ["unet", "dit"])
def test_cpu_forward_takes_the_plain_version(family, grad):
    """A CPU forward spans each attention block once and launches nothing."""
    if family == "unet":
        net = init_unet_params(torch.Generator().manual_seed(0), SMALL_UNET, device="cpu")
        x, blocks = torch.randn(1, 4, 16, 16), _blocks(net, "Attention")
    else:
        net = init_dit_params(torch.Generator().manual_seed(0), SMALL_DIT, device="cpu")
        x, blocks = torch.randn(2, 4, 16, 16), _blocks(net, "Block")
    sigma = torch.full((x.shape[0],), 2.0)
    before = A.fused_attention.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset_spans()
        with torch.set_grad_enabled(grad):
            net(x, sigma)
        spans = profiling.span_totals()
    profiling.reset_spans()
    assert blocks > 0
    assert spans["sonar.attention"]["count"] == blocks
    assert A.fused_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_forward_unchanged(monkeypatch, dtype):
    cfg = UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                     attention_levels=(0, 1), num_heads=2, norm_groups=8, dtype=dtype)
    net = init_unet_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(2)) * 3
    sigma = torch.tensor([0.5, 7.0])
    with torch.no_grad():
        got = net(x, sigma)
        monkeypatch.setattr(U.Attention, "forward", _old_unet_forward)
        want = net(x, sigma)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts", [0, 4])
def test_dit_forward_unchanged(monkeypatch, dtype, experts):
    cfg = DiTConfig(hidden=64, depth=2, num_heads=4, num_experts=experts, dtype=dtype)
    net = init_dit_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(2)) * 3
    sigma = torch.tensor([0.5, 7.0])
    with torch.no_grad():
        got = net(x, sigma)
        monkeypatch.setattr(Block, "attention", _old_dit_attention)
        want = net(x, sigma)
    assert torch.equal(got, want)


def test_dit_gradients_unchanged(monkeypatch):
    net = init_dit_params(torch.Generator().manual_seed(1), SMALL_DIT, device="cpu")
    x = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(2))
    sigma = torch.tensor([0.5, 7.0])

    def grads():
        net.zero_grad()
        net(x, sigma).square().mean().backward()
        return [p.grad.clone() for p in net.parameters()]

    got = grads()
    monkeypatch.setattr(Block, "attention", _old_dit_attention)
    want = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d, width", [(8, 40), (32, 40), (40, 40), (41, 64), (64, 64),
                                      (72, 72), (80, 80), (96, 128), (128, 128), (129, 160),
                                      (160, 160), (200, 256), (256, 256)])
def test_kernel_width(d, width):
    assert A.kernel_width(d) == width


@pytest.mark.parametrize("case", ["width", "axis", "dtype", "int", "stride", "layout", "empty"])
def test_wrapper_refuses(case):
    qkv = _qkv("unet", 1, 8, 2, 8)
    layout, err = "unet", ValueError
    if case == "width":
        qkv = _qkv("unet", 1, 4, 1, 257)
    elif case == "axis":
        layout = "dit"  # (1, 8, 3, 2, 8) read head-major: the q/k/v axis holds 2
    elif case == "dtype":
        qkv, err = qkv.double(), TypeError
    elif case == "int":
        qkv, err = qkv.to(torch.int32), TypeError
    elif case == "stride":
        qkv = qkv.transpose(-1, -2)
    elif case == "layout":
        layout = "nhd"
    else:
        qkv = _qkv("unet", 1, 0, 2, 8)
    with pytest.raises(err):
        A._check_call(qkv, layout)


def test_build_flags_per_source(monkeypatch):
    assert "-fmad=true" in _build.nvcc_flags("attention.cu")
    for src in ("fused.cu", "hwrng.cu", "fused_pyramid.cu", "voronoi.cu"):
        flags = _build.nvcc_flags(src)
        assert "-fmad=false" in flags and "-fmad=true" not in flags
    assert "attention.cu" in _build.SOURCES
    before = _build.source_hash()
    monkeypatch.setitem(_build.FMAD, "attention.cu", "-fmad=false")
    assert _build.source_hash() != before  # the hash covers each source's flags


def test_kernel_source_calls_no_library():
    src = (pathlib.Path(_build.CSRC) / "attention.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for name in ("cublas", "cudnn", "scaled_dot_product", "wgmma"):
        assert name not in code.lower(), name
    ffma = code[code.index("attention_ffma_kernel(Args a)"):code.index("struct Tf32")]
    assert "mma" not in ffma  # with TF32 off: FMAs only, no tensor-core instruction
