"""Flagship denoiser: the latent-diffusion UNet as a PyTorch ``nn.Module``
(port of ``sonar_tpu.models.unet``).

An SD-style epsilon-prediction UNet (resblocks, self-attention, skip
connections) with k-diffusion preconditioning in :func:`make_denoiser`, so
the returned callable satisfies the sampler protocol exactly. The module
tree mirrors the JAX parameter tree, so :func:`unet_params_from_jax` maps a
JAX pytree onto the module's ``state_dict`` by name.

Latents are (B, C, H, W) and the module computes in NCHW. What must match
XLA and needs care in PyTorch:

- convolutions pad like XLA's ``"SAME"``: a stride-2 3×3 conv on an even
  size pads 0 before and 1 after, where ``nn.Conv2d(padding=1)`` pads both
  sides;
- group norm reduces the group count until it divides the channels;
- attention splits qkv as ``(b, n, 3, heads, d)`` and takes its logits in
  float32;
- the sigma embedding's angles and the conditioning sigma stay float32.

The UNet holds no hand-written kernel: its convolutions, norms and
attention are PyTorch operators.

Sharded training: :func:`sonar_tpu_torch.parallel.shard_unet_params` gives
each conv and dense layer a :class:`LayerLayout`. Under tp a layer holds its
share of the weight (the JAX package's ``unet_param_shardings``): a
column-parallel layer (every conv, ``qkv``, ``emb``, ``time_mlp.fc1``)
computes its output features and gathers them, then adds the whole bias; a
row-parallel one (``proj``, ``time_mlp.fc2``) multiplies its slice of the
input features and sums the partial products over tp. Everything between
(group norms, attention, the skips) runs on whole activations, so the
attention's head split of ``qkv`` is the JAX layout's whatever tp is. An
FSDP weight is gathered before each use. The collectives carry gradients
(:mod:`sonar_tpu_torch.parallel.grad`).

``block_patches`` is the hook surface FreeU-Extreme installs into
(:func:`sonar_tpu_torch.cfg.freeu.make_freeu_patches`), as in the JAX
package: ``input`` patches run after ``conv_in``, after every down block and
after every downsample, and the patched tensor goes onto the skip stack;
``middle`` runs after the mid block; ``output`` gets ``(h, skip)`` before
their concatenation. Each sees ``ctx["sigma"]``: the true float32 sigma
batch, never what ``timestep_fn`` conditions the network on. Activations
are NCHW, as the module computes. Without patches a forward runs exactly the
operators it runs with none installed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.grad import copy_to, fsdp_gather, gather, reduce_from
from ..utils.misc import default_device


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 64
    channel_mult: tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 1
    attention_levels: tuple[int, ...] = (1, 2)
    num_heads: int = 4
    norm_groups: int = 8
    dtype: Any = torch.float32

    @property
    def emb_channels(self) -> int:
        return self.model_channels * 4

    def level_channels(self, level: int) -> int:
        return self.model_channels * self.channel_mult[level]


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding (before, after) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass(frozen=True)
class LayerLayout:
    """How a rank of a sharded UNet holds one conv or dense layer (set by
    :func:`sonar_tpu_torch.parallel.shard_unet_params`): ``tp`` the mesh axis
    its weight is split on (``kind`` "column": output features, "row": input
    features; a 1-rank axis runs the same collectives), ``fsdp`` the axis
    one more dimension, ``fsdp_dim``, is split on (the block is gathered
    before each use), None where whole."""

    mesh: Any
    tp: str
    kind: str
    fsdp: str | None = None
    fsdp_dim: int | None = None

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """The rank's tp block of the weight, its FSDP blocks gathered."""
        return w if self.fsdp is None else fsdp_gather(w, self.mesh, self.fsdp, self.fsdp_dim)

    def column(self, product, x, bias, dim: int):
        """A column-parallel layer: this rank's output features of
        ``product(x)``, gathered over tp, then the (whole) bias."""
        y = gather(product(copy_to(x, self.mesh, self.tp)), self.mesh, self.tp, dim)
        return y + (bias if dim == -1 else bias.view(-1, 1, 1))


class Conv(nn.Conv2d):
    """Square conv with XLA "SAME" padding. ``init_scale`` multiplies the
    init std (1e-2 for the zero-ish output convs, as in the JAX init).
    ``layout`` (a :class:`LayerLayout`) makes it a rank's part of a sharded
    conv: column-parallel under tp."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 init_scale: float = 1.0):
        # stride 1 with an odd kernel pads symmetrically, so the conv pads
        # itself; strided convs pad explicitly in forward
        super().__init__(cin, cout, k, stride=stride,
                         padding=k // 2 if stride == 1 else 0)
        self.init_scale = init_scale
        self.layout = None

    def forward(self, x):
        if self.stride[0] != 1:
            k, s = self.kernel_size[0], self.stride[0]
            x = F.pad(x, (*_same_pad(x.shape[-1], k, s), *_same_pad(x.shape[-2], k, s)))
        lay = self.layout
        if lay is None:
            return super().forward(x)
        w = lay.weight(self.weight)
        return lay.column(lambda v: self._conv_forward(v, w, None), x, self.bias, 1)


class Dense(nn.Linear):
    """``nn.Linear`` with the init's scale; ``layout`` as :class:`Conv`'s,
    column- or row-parallel under tp (a row-parallel rank multiplies its
    slice of the input features and the partial products are summed)."""

    def __init__(self, din: int, dout: int, init_scale: float = 1.0):
        super().__init__(din, dout)
        self.init_scale = init_scale
        self.layout = None

    def forward(self, x):
        lay = self.layout
        if lay is None:
            return super().forward(x)
        w = lay.weight(self.weight)
        if lay.kind == "column":
            return lay.column(lambda v: F.linear(v, w), x, self.bias, -1)
        k = w.shape[1]
        me = lay.mesh.get_local_rank(lay.tp)
        xs = copy_to(x, lay.mesh, lay.tp).narrow(-1, me * k, k)
        return reduce_from(F.linear(xs, w), lay.mesh, lay.tp) + self.bias


def _group_norm(c: int, groups: int) -> nn.GroupNorm:
    g = min(groups, c)
    while c % g:
        g -= 1
    return nn.GroupNorm(g, c, eps=1e-5)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cemb: int, groups: int):
        super().__init__()
        self.norm1 = _group_norm(cin, groups)
        self.conv1 = Conv(cin, cout, 3)
        self.emb = Dense(cemb, cout)
        self.norm2 = _group_norm(cout, groups)
        self.conv2 = Conv(cout, cout, 3, init_scale=1e-2)
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.emb(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class Attention(nn.Module):
    def __init__(self, c: int, num_heads: int, groups: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = _group_norm(c, groups)
        self.qkv = Dense(c, 3 * c)
        self.proj = Dense(c, c, init_scale=1e-2)

    def forward(self, x):
        b, c, h, w = x.shape
        n, heads = h * w, self.num_heads
        y = self.norm(x).reshape(b, c, n).transpose(1, 2)  # (b, n, c)
        q, k, v = self.qkv(y).reshape(b, n, 3, heads, c // heads).unbind(2)
        scale = 1.0 / math.sqrt(c // heads)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return x + self.proj(out).transpose(1, 2).reshape(b, c, h, w)


class _Level(nn.Module):
    def __init__(self, blocks: list[nn.ModuleDict], downsample=None, upsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample
        self.upsample = upsample


def _sigma_embedding(sigma, ch: int, dtype):
    """Fourier features of log-sigma, cos before sin. The angles are float32
    whatever the compute dtype: they reach hundreds of radians, where bf16
    would turn the top bands into noise."""
    half = ch // 2
    logs = torch.log(torch.clamp(sigma, min=1e-10)) / 4.0
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=sigma.device)
        * (-math.log(10000.0) / max(half - 1, 1)))
    ang = logs[:, None].float() * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).to(dtype)


def _maybe_patch(patches, name, *args, ctx):
    """Run the ``name`` patches over ``args`` in order (each returns one
    tensor, or a tuple for ``output``)."""
    out = args
    for fn in (patches or {}).get(name, ()):
        res = fn(*out, ctx)
        out = res if isinstance(res, tuple) else (res,)
    return out if len(out) > 1 else out[0]


class UNet(nn.Module):
    """Predicts epsilon for latent ``x`` (B,C,H,W) at noise level ``sigma`` (B,)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch, cemb, g = cfg.model_channels, cfg.emb_channels, cfg.norm_groups

        def block(cin, cout, level):
            blk = {"res": ResBlock(cin, cout, cemb, g)}
            if level in cfg.attention_levels:
                blk["attn"] = Attention(cout, cfg.num_heads, g)
            return nn.ModuleDict(blk)

        self.time_mlp = nn.ModuleDict({"fc1": Dense(ch, cemb), "fc2": Dense(cemb, cemb)})
        self.conv_in = Conv(cfg.in_channels, ch, 3)
        skip_chs, cur = [ch], ch
        down = []
        for level in range(len(cfg.channel_mult)):
            cout = cfg.level_channels(level)
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(block(cur, cout, level))
                cur = cout
                skip_chs.append(cur)
            ds = None
            if level != len(cfg.channel_mult) - 1:
                ds = Conv(cur, cur, 3, stride=2)
                skip_chs.append(cur)
            down.append(_Level(blocks, downsample=ds))
        self.down = nn.ModuleList(down)
        self.mid = nn.ModuleDict({
            "res1": ResBlock(cur, cur, cemb, g),
            "attn": Attention(cur, cfg.num_heads, g),
            "res2": ResBlock(cur, cur, cemb, g),
        })
        up = []
        for level in reversed(range(len(cfg.channel_mult))):
            cout = cfg.level_channels(level)
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(block(cur + skip_chs.pop(), cout, level))
                cur = cout
            up.append(_Level(blocks, upsample=Conv(cur, cur, 3) if level != 0 else None))
        self.up = nn.ModuleList(up)
        self.norm_out = _group_norm(cur, g)
        self.conv_out = Conv(cur, cfg.out_channels, 3, init_scale=1e-2)

    def forward(self, x, sigma, *, block_patches: dict[str, list[Callable]] | None = None,
                patch_sigma: torch.Tensor | None = None):
        """``block_patches`` maps ``"input"``, ``"middle"``, ``"output"`` to
        lists of patch functions (module docstring); ``patch_sigma`` is what
        they see as ``ctx["sigma"]`` when the network is conditioned on
        something else than sigma (default: ``sigma``)."""
        dt = self.cfg.dtype
        p = block_patches
        ctx = {"sigma": sigma if patch_sigma is None else patch_sigma, "cfg": self.cfg}
        t = self.time_mlp
        emb = t["fc2"](F.silu(t["fc1"](
            _sigma_embedding(sigma, self.cfg.model_channels, dt))))
        h = _maybe_patch(p, "input", self.conv_in(x.to(dt)), ctx=ctx)
        skips = [h]
        for level in self.down:
            for blk in level.blocks:
                h = blk["res"](h, emb)
                if "attn" in blk:
                    h = blk["attn"](h)
                h = _maybe_patch(p, "input", h, ctx=ctx)
                skips.append(h)
            if level.downsample is not None:
                h = _maybe_patch(p, "input", level.downsample(h), ctx=ctx)
                skips.append(h)
        h = self.mid["res1"](h, emb)
        h = self.mid["attn"](h)
        h = _maybe_patch(p, "middle", self.mid["res2"](h, emb), ctx=ctx)
        for level in self.up:
            for blk in level.blocks:
                h, hsp = _maybe_patch(p, "output", h, skips.pop(), ctx=ctx)
                h = blk["res"](torch.cat([h, hsp], dim=1), emb)
                if "attn" in blk:
                    h = blk["attn"](h)
            if level.upsample is not None:
                h = level.upsample(F.interpolate(h, scale_factor=2, mode="nearest"))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.to(x.dtype)


@torch.no_grad()
def init_unet_params(generator: torch.Generator, cfg: UNetConfig = UNetConfig(),
                     device=None) -> UNet:
    """A UNet with random weights drawn from ``generator`` (a CPU generator):
    each conv and dense weight is normal with std ``init_scale/sqrt(fan_in)``,
    as in the JAX init; biases are zero and norms the identity. The weights
    are drawn on the host and moved to ``device`` once; ``device=None`` means
    the card, and without one this raises before any weight is drawn."""
    device = default_device(device)
    torch.empty(0, device=device)
    with torch.device("meta"):  # skip torch's default init and its global RNG
        model = UNet(cfg)
    model = model.to_empty(device="cpu")
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = m.weight[0].numel()
            std = m.init_scale * math.sqrt(1.0 / fan_in)
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model.to(device=device, dtype=cfg.dtype).eval()


def unet_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Map the JAX UNet parameter pytree (leaves as numpy arrays) onto
    :class:`UNet`'s ``state_dict``: conv weights HWIO → OIHW, dense weights
    (din, dout) → (dout, din), norm ``scale``/``bias`` → ``weight``/``bias``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, str(k)))
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, (*path, str(i)))
            return
        a = np.asarray(node)
        *parent, leaf = path
        if leaf == "w":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf == "b":
            leaf = "bias"
        out[".".join((*parent, leaf))] = torch.tensor(np.ascontiguousarray(a))

    walk(tree, ())
    return out


def unet_apply(model: UNet, x: torch.Tensor, sigma: torch.Tensor, *,
               block_patches: dict[str, list[Callable]] | None = None,
               patch_sigma: torch.Tensor | None = None) -> torch.Tensor:
    """Predict epsilon for latent ``x`` (B,C,H,W) at noise level ``sigma``
    (B,), with ``block_patches`` and ``patch_sigma`` as :meth:`UNet.forward`
    takes them."""
    return model(x, sigma, block_patches=block_patches, patch_sigma=patch_sigma)


def make_denoiser(model: UNet, *, block_patches: dict[str, list[Callable]] | None = None,
                  prediction="eps", params_kwarg: str = "params",
                  timestep_fn: Callable | None = None) -> Callable:
    """Wrap the UNet into the sampler's denoiser protocol
    ``model(x, sigma_batch) -> denoised``.

    ``prediction`` names what the raw network output means (see
    :mod:`sonar_tpu_torch.models.prediction`): ``"eps"`` (default),
    ``"v"``, ``"x0"``, or ``"const"``/``"flow"``. The latent arithmetic runs
    in ``x.dtype`` on the float32 sigma batch.

    ``timestep_fn`` maps the float32 sigma batch to what the network is
    conditioned on (default: sigma itself; flow models are conditioned on
    ``sigma * 1000``, ``cfg.Flow().timestep``). The preconditioning and
    the ``block_patches`` always see the true sigma.

    ``params_kwarg`` names the call-time weight override: a call with
    ``params_kwarg=`` a dict of tensors keyed as :func:`unet_params_from_jax`
    keys them (the module's ``state_dict`` names; a subset overrides only
    those) runs the module on those weights through
    ``torch.func.functional_call``. The samplers' ``extra_args`` reach every
    denoiser of a CFG pair, so two denoisers with different weights need
    distinct names. Runs without autograd."""
    from .prediction import get_prediction

    pred = get_prediction(prediction)

    @torch.no_grad()
    def denoiser(x, sigma, **kw):
        sb32 = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sb32 = sb32.reshape(-1).expand(x.shape[0])
        s4 = sb32.to(x.dtype).reshape(-1, 1, 1, 1)
        cond = sb32 if timestep_fn is None else timestep_fn(sb32)
        xin = pred.calculate_input(s4, x)
        p = kw.get(params_kwarg)
        hooks = {"block_patches": block_patches, "patch_sigma": sb32}
        out = (model(xin, cond, **hooks) if p is None
               else torch.func.functional_call(model, p, (xin, cond), hooks))
        return pred.calculate_denoised(s4, out, x)

    return denoiser
