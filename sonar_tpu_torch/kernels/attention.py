"""The denoisers' attention core: kernel B7 beside its plain version.

softmax(q·kᵀ·scale)·v over every (batch, head) of a packed ``qkv``, the
output in the ``(b, n, heads·d)`` layout that the output projection reads.
Two packings, read by strides:

- ``"unet"``: ``(b, n, 3, heads, d)`` (``models/unet.py Attention``);
- ``"dit"``: head-major, ``(b, n, heads, 3, d)`` (``models/dit.py Block``).

:func:`attention_reference` is the plain version: each model's operator
expression (float32 logits, the softmax cast to the input's type before the
value product); the two differ in how they scale and order their products. The kernel
(``csrc/attention.cu``; it replaces no TPU kernel) computes the same in
one pass over key tiles and never writes a logit to device memory. Its
products follow ``torch.backends.cuda.matmul.allow_tf32``, which the
operators obey too: off, float32 FMAs; on, TF32 tensor-core products with
float32 accumulation. The softmax is float32 either way. A bf16 or fp16
``qkv`` is widened to float32 before the launch and the output rounded to
its type after it. :func:`b7_tile` picks the kernel's tile from what the
call shows: TF32 off, the FFMA tile; on, Hopper's warpgroup (``wgmma``)
tile at the head widths 72 and 128 where the copies can go 16 bytes at a
time (:func:`aligned`), the ``mma.sync`` tile otherwise.

:func:`fused_attention` is the models' one entry point: the kernel on a
CUDA tensor (under autograd through :class:`_Attention`, whose backward
recomputes the operators' graph from ``qkv``), the plain version on any
other; it counts kernel launches in ``launches``, and those of the
``wgmma`` tile in ``wgmma_launches``.
"""

from __future__ import annotations

import math

import torch

LAYOUTS = ("unet", "dit")
WIDTHS = (40, 64, 72, 80, 128, 160, 256)  # the kernel's instantiated head widths
WGMMA_WIDTHS = (72, 128)  # the widths the wgmma tile serves
TILES = ("ffma", "mma", "wgmma")  # the kernel's tiles, by the number it takes
_MAX_PLANES = 65535  # batch × heads: the grid's y dimension
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _axes(layout: str) -> tuple[int, int]:
    """(head axis, q/k/v axis) of ``qkv`` in ``layout``."""
    if layout == "unet":
        return 3, 2
    if layout == "dit":
        return 2, 3
    raise ValueError(f"attention: layout must be one of {LAYOUTS}, got {layout!r}")


def kernel_width(d: int) -> int:
    """The instantiated width a head of ``d`` runs on (the extra dimensions
    zero-filled); raises above the widest."""
    for w in WIDTHS:
        if d <= w:
            return w
    raise ValueError(f"attention: head width {d} is above the kernel's {WIDTHS[-1]}")


def b7_tile(width: int, tf32: bool, aligned: bool) -> str:
    """The tile kernel B7 runs a call on, from its instantiated head width,
    the TF32 flag and whether its copies can go 16 bytes at a time:
    ``"wgmma"`` (TF32, widths 72 and 128, aligned), ``"mma"`` (any other
    TF32 call: 160 and 256, whose 64 × width accumulators would crowd a
    warpgroup's registers, and every misaligned one) or ``"ffma"`` (TF32
    off)."""
    if not tf32:
        return "ffma"
    return "wgmma" if width in WGMMA_WIDTHS and aligned else "mma"


def aligned(x: torch.Tensor, layout: str) -> bool:
    """Whether B7 can copy float32 ``x`` 16 bytes at a time: its base, every
    stride it reads and the head width multiples of 4 floats."""
    head_axis, which_axis = _axes(layout)
    strides = (x.stride(0), x.stride(1), x.stride(head_axis), x.stride(which_axis))
    return (x.data_ptr() % 16 == 0 and x.shape[4] % 4 == 0
            and all(s % 4 == 0 for s in strides))


def attention_reference(qkv: torch.Tensor, layout: str) -> torch.Tensor:
    """Plain PyTorch version of kernel B7: the models' operator expressions."""
    _axes(layout)
    if layout == "unet":
        b, n, _, heads, d = qkv.shape
        q, k, v = qkv.unbind(2)
        scale = 1.0 / math.sqrt(d)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
        attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
        return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, heads * d)
    b, n, heads, _, d = qkv.shape
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    att = torch.softmax(logits / math.sqrt(d), dim=-1)
    out = torch.matmul(att.to(qkv.dtype), v)
    return out.transpose(1, 2).reshape(b, n, heads * d)


def _check_call(qkv: torch.Tensor, layout: str) -> None:
    head_axis, which_axis = _axes(layout)
    if qkv.ndim != 5 or qkv.shape[which_axis] != 3:
        raise ValueError(f"attention: qkv must be 5-D with q, k, v on axis {which_axis} "
                         f"for layout {layout!r}, got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"attention: the kernel takes float32, bf16 or fp16, got {qkv.dtype}")
    b, n, d = qkv.shape[0], qkv.shape[1], qkv.shape[4]
    heads = qkv.shape[head_axis]
    kernel_width(d)
    if min(b, n, heads, d) < 1 or b * heads > _MAX_PLANES:
        raise ValueError(f"attention: qkv {tuple(qkv.shape)}: empty, or more than "
                         f"{_MAX_PLANES} (batch, head) planes")
    if qkv.stride(4) != 1:
        raise ValueError("attention: a head's dimensions must be contiguous (stride 1)")


def _launch(qkv: torch.Tensor, layout: str) -> torch.Tensor:
    """One launch of the kernel on ``qkv`` (checked first; bf16 or fp16
    widened to float32 for it, the output rounded back)."""
    _check_call(qkv, layout)
    head_axis, which_axis = _axes(layout)
    b, n, d = qkv.shape[0], qkv.shape[1], qkv.shape[4]
    heads = qkv.shape[head_axis]
    from ._build import check, load_library

    lib = load_library()
    x = qkv.float()  # qkv itself where float32
    out = torch.empty((b, n, heads * d), dtype=torch.float32, device=qkv.device)
    width = kernel_width(d)
    tile = b7_tile(width, bool(torch.backends.cuda.matmul.allow_tf32), aligned(x, layout))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sonar_attention(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(head_axis),
            x.stride(which_axis), b, n, heads, d, width, out.data_ptr(),
            out.stride(0), out.stride(1), d, 1.0 / math.sqrt(d), TILES.index(tile), stream)
    check(lib, err, "attention")
    fused_attention.launches += 1
    fused_attention.wgmma_launches += tile == "wgmma"
    return out.to(qkv.dtype)


class _Attention(torch.autograd.Function):
    """The kernel under autograd: the forward launches it and keeps only
    ``qkv``; the backward rebuilds the plain version's graph from ``qkv``
    and differentiates that (the logits exist again only there)."""

    @staticmethod
    def forward(ctx, qkv, layout):
        ctx.layout = layout
        ctx.save_for_backward(qkv)
        return _launch(qkv, layout)

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            out = attention_reference(x, ctx.layout)
        return torch.autograd.grad(out, x, grad)[0], None


def fused_attention(qkv: torch.Tensor, layout: str) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v for ``qkv`` packed as ``layout``; returns
    ``(b, n, heads·d)`` in ``qkv``'s type.

    A CUDA tensor takes the kernel: it must be float32, bf16 or fp16 with
    its head dimensions contiguous and ``d`` at most 256, or this raises;
    where autograd records, the launch goes through :class:`_Attention`.
    Any other tensor (the CPU's, or ``meta`` for FLOP counting) takes the
    plain version."""
    if qkv.device.type != "cuda":
        return attention_reference(qkv, layout)
    if qkv.requires_grad and torch.is_grad_enabled():
        return _Attention.apply(qkv, layout)
    return _launch(qkv, layout)


fused_attention.launches = 0
fused_attention.wgmma_launches = 0
