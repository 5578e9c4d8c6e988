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
attention are PyTorch operators. The FreeU ``block_patches`` hooks come with
the FreeU slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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


class Conv(nn.Conv2d):
    """Square conv with XLA "SAME" padding. ``init_scale`` multiplies the
    init std (1e-2 for the zero-ish output convs, as in the JAX init)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 init_scale: float = 1.0):
        # stride 1 with an odd kernel pads symmetrically, so the conv pads
        # itself; strided convs pad explicitly in forward
        super().__init__(cin, cout, k, stride=stride,
                         padding=k // 2 if stride == 1 else 0)
        self.init_scale = init_scale

    def forward(self, x):
        if self.stride[0] != 1:
            k, s = self.kernel_size[0], self.stride[0]
            x = F.pad(x, (*_same_pad(x.shape[-1], k, s), *_same_pad(x.shape[-2], k, s)))
        return super().forward(x)


class Dense(nn.Linear):
    def __init__(self, din: int, dout: int, init_scale: float = 1.0):
        super().__init__(din, dout)
        self.init_scale = init_scale


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

    def forward(self, x, sigma):
        dt = self.cfg.dtype
        t = self.time_mlp
        emb = t["fc2"](F.silu(t["fc1"](
            _sigma_embedding(sigma, self.cfg.model_channels, dt))))
        h = self.conv_in(x.to(dt))
        skips = [h]
        for level in self.down:
            for blk in level.blocks:
                h = blk["res"](h, emb)
                if "attn" in blk:
                    h = blk["attn"](h)
                skips.append(h)
            if level.downsample is not None:
                h = level.downsample(h)
                skips.append(h)
        h = self.mid["res1"](h, emb)
        h = self.mid["attn"](h)
        h = self.mid["res2"](h, emb)
        for level in self.up:
            for blk in level.blocks:
                h = blk["res"](torch.cat([h, skips.pop()], dim=1), emb)
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
    are drawn on the host and moved to ``device`` once."""
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


def unet_apply(model: UNet, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Predict epsilon for latent ``x`` (B,C,H,W) at noise level ``sigma`` (B,)."""
    return model(x, sigma)


def make_denoiser(model: UNet, *, prediction="eps") -> Callable:
    """Wrap the UNet into the sampler's denoiser protocol
    ``model(x, sigma_batch) -> denoised``.

    ``prediction`` names what the raw network output means (see
    :mod:`sonar_tpu_torch.models.prediction`): ``"eps"`` (default),
    ``"v"``, ``"x0"``, or ``"const"``/``"flow"``. The network is conditioned
    on the float32 sigma batch; the latent arithmetic runs in ``x.dtype``.
    Runs without autograd."""
    from .prediction import get_prediction

    pred = get_prediction(prediction)

    @torch.no_grad()
    def denoiser(x, sigma, **_kw):
        sb32 = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sb32 = sb32.reshape(-1).expand(x.shape[0])
        s4 = sb32.to(x.dtype).reshape(-1, 1, 1, 1)
        out = model(pred.calculate_input(s4, x), sb32)
        return pred.calculate_denoised(s4, out, x)

    return denoiser
