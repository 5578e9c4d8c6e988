"""FLUX.1 (Black Forest Labs' rectified-flow transformer) as a PyTorch
``nn.Module``, with the denoiser maker that binds a prompt's encodings.

The equations are those of github.com/black-forest-labs/flux
(``src/flux/model.py``, ``src/flux/modules/layers.py``), and the parameters
carry that repository's names, so a FLUX.1 state dict loads as it is. The
JAX package has no FLUX model: the CPU tests hold this one to the plain
reference ``benchmark/reference/flux.py``.

- tokens: the latent's 2×2 patches, ``b c (h 2) (w 2) -> b (h w) (c 2 2)``
  (channel first, unlike the DiT's ``_patchify``), embedded by ``img_in``;
  the prompt's T5 encoding by ``txt_in``;
- the conditioning vector ``vec``: ``time_in`` on the time embedding of σ
  (``temb(t) = [cos(1000·t·f), sin(1000·t·f)]``, 128 frequencies
  ``f_j = 10⁴^(−j/128)``), plus ``guidance_in`` on that of the guidance
  value, plus ``vector_in`` on the pooled CLIP vector, each
  ``Linear → SiLU → Linear``;
- positions: text tokens at (0, 0, 0), image token (row, col) at
  (0, row, col); RoPE over three axes of widths ``axes_dim`` rotates the
  adjacent pairs (2j, 2j+1) of every q and k head by ``pos·θ^(−2j/a)``,
  angles, cosines and sines in float64, stored float32;
- a double-stream block: text and image each have their own modulation
  (two shift, scale, gate triples), qkv, q/k RMSNorm, output projection and
  MLP; their q, k, v meet in one attention over ``cat(txt, img)``;
- a single-stream block on ``cat(txt, img)``: one modulation triple, one
  input projection giving qkv and the MLP's hidden, attention, and one
  output projection over ``cat(attn, gelu(hidden))``;
- the head: the text tokens dropped, a final adaLN (shift, scale) and a
  linear back to patches.

The layer norm is the DiT's (affine-free, eps 1e-6, float32 statistics),
as are the modulation and the tanh GELU (``models/dit.py``). q and k are
RMS-normalised in float32 (eps 1e-6), cast back, times a learned scale of
the head width; RoPE runs in float32 after the norms.

The attention core is kernel B7 (``csrc/attention.cu``) on the card and its
plain version on the CPU, through
:func:`~sonar_tpu_torch.kernels.attention.fused_attention` in the
``"unet"`` packing ``(b, n, 3, heads, d)``, which is FLUX's own ``(K H D)``
order of the qkv projection's features. A single block's qkv is a view into
its input projection's output, normalised and rotated in place and read by
strides; a double block makes one packed copy, ``cat(txt_qkv, img_qkv)``,
and does the same to it. Spans: ``sonar.flux.double`` and
``sonar.flux.single`` around each block, ``sonar.rope`` around its q/k
norms, RoPE and packing, ``sonar.attention`` around each B7 call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import fused_attention
from ..utils.misc import default_device
from ..utils.profiling import span
from .dit import _gelu, _layer_norm, _modulate


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """FLUX.1's ``FluxParams`` (``src/flux/util.py``); the defaults are
    ``configs["flux-dev"]``. ``in_channels`` counts a token's features (the
    latent's channels × 4). The qkv projections have biases and the guidance
    embedding is there, as in FLUX.1-dev."""

    in_channels: int = 64
    out_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: int = 4
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return self.hidden_size * self.mlp_ratio


def _patchify(x):
    """``b c (h 2) (w 2) -> b (h w) (c 2 2)``: ``(tokens, hp, wp)``."""
    b, c, hh, ww = x.shape
    hp, wp = hh // 2, ww // 2
    x = x.reshape(b, c, hp, 2, wp, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, hp * wp, c * 4), hp, wp


def _unpatchify(tok, hp: int, wp: int):
    b, _, f = tok.shape
    x = tok.reshape(b, hp, wp, f // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, f // 4, hp * 2, wp * 2)


def timestep_embedding(t: torch.Tensor, dim: int = 256, time_factor: float = 1000.0):
    """FLUX's ``timestep_embedding``: ``[cos(args), sin(args)]`` with
    ``args = time_factor·t·f``, ``f_j = exp(−ln(10⁴)·j/(dim/2))``, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = (t.float() * time_factor)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=8)
def _rope_table(hp: int, wp: int, txt: int, axes_dim: tuple[int, ...], theta: int, device):
    """``(cos, sin)``, each ``(txt + hp·wp, 1, 1, head_dim/2)`` float32, of
    the joint sequence's positions: text tokens at 0 on every axis, image
    token (r, c) at (0, r, c). Built once per size in float64 on the host
    and cached on ``device``."""
    ids = torch.zeros(txt + hp * wp, len(axes_dim), dtype=torch.float64)
    ids[txt:, 1] = torch.arange(hp, dtype=torch.float64).repeat_interleave(wp)
    ids[txt:, 2] = torch.arange(wp, dtype=torch.float64).repeat(hp)
    angles = []
    for i, a in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, a, 2, dtype=torch.float64) / a)
        angles.append(ids[:, i, None] * omega[None, :])
    ang = torch.cat(angles, dim=-1)[:, None, None, :]
    return (torch.cos(ang).to(device=device, dtype=torch.float32),
            torch.sin(ang).to(device=device, dtype=torch.float32))


def _qk_norm_rope(qk, scales, cos, sin) -> None:
    """q and k of ``qk`` (b, n, 2, heads, d), a view into B7's packed
    buffer, in place: each RMS-normalised over its head (float32, eps 1e-6),
    cast back and times its learned scale, then rotated by RoPE in float32.
    ``scales`` is ``[(rows, q_scale, k_scale), ...]``, the streams' token
    ranges of the joint sequence with their norms' scales."""
    x = qk.float()
    x = (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)).to(qk.dtype)
    for rows, q_scale, k_scale in scales:
        x[:, rows] *= torch.stack([q_scale, k_scale])[:, None, :]
    x = x.float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    qk[..., 0::2] = cos * x0 - sin * x1
    qk[..., 1::2] = sin * x0 + cos * x1


class MLPEmbedder(nn.Module):
    def __init__(self, din: int, d: int):
        super().__init__()
        self.in_layer = nn.Linear(din, d)
        self.out_layer = nn.Linear(d, d)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    """The learned scale of one of q and k's norms (applied by
    :func:`_qk_norm_rope`)."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))


class QKNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query_norm = RMSNorm(d)
        self.key_norm = RMSNorm(d)


class SelfAttention(nn.Module):
    """One stream's qkv projection, q/k norms and output projection."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.hidden_size
        self.qkv = nn.Linear(d, 3 * d)
        self.norm = QKNorm(cfg.head_dim)
        self.proj = nn.Linear(d, d)


class Modulation(nn.Module):
    """``Linear(silu(vec))`` chunked into ``n`` (shift, scale, gate)
    triples."""

    def __init__(self, d: int, n: int):
        super().__init__()
        self.n = n
        self.lin = nn.Linear(d, 3 * n * d)

    def forward(self, vec):
        return self.lin(F.silu(vec)).chunk(3 * self.n, dim=-1)


def _mlp(cfg: FluxConfig) -> nn.Sequential:
    return nn.Sequential(nn.Linear(cfg.hidden_size, cfg.mlp_hidden),
                         nn.GELU(approximate="tanh"),
                         nn.Linear(cfg.mlp_hidden, cfg.hidden_size))


class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(d, 2))
            setattr(self, f"{s}_attn", SelfAttention(cfg))
            setattr(self, f"{s}_mlp", _mlp(cfg))

    def forward(self, img, txt, vec, pe):
        b, ni, d = img.shape
        nt = txt.shape[1]
        heads = self.cfg.num_heads
        im = self.img_mod(vec)
        tm = self.txt_mod(vec)
        img_qkv = self.img_attn.qkv(_modulate(_layer_norm(img), im[0], im[1]))
        txt_qkv = self.txt_attn.qkv(_modulate(_layer_norm(txt), tm[0], tm[1]))
        tn, imn = self.txt_attn.norm, self.img_attn.norm
        with span("sonar.rope"):
            qkv = torch.cat([txt_qkv, img_qkv], dim=1).view(b, nt + ni, 3, heads, d // heads)
            _qk_norm_rope(qkv[:, :, :2], [
                (slice(0, nt), tn.query_norm.scale, tn.key_norm.scale),
                (slice(nt, None), imn.query_norm.scale, imn.key_norm.scale)], *pe)
        with span("sonar.attention"):
            attn = fused_attention(qkv, "unet")
        img = img + im[2][:, None, :] * self.img_attn.proj(attn[:, nt:])
        img = img + im[5][:, None, :] * self.img_mlp(_modulate(_layer_norm(img), im[3], im[4]))
        txt = txt + tm[2][:, None, :] * self.txt_attn.proj(attn[:, :nt])
        txt = txt + tm[5][:, None, :] * self.txt_mlp(_modulate(_layer_norm(txt), tm[3], tm[4]))
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.linear1 = nn.Linear(d, 3 * d + cfg.mlp_hidden)
        self.linear2 = nn.Linear(d + cfg.mlp_hidden, d)
        self.norm = QKNorm(cfg.head_dim)
        self.modulation = Modulation(d, 1)

    def forward(self, x, vec, pe):
        d = x.shape[-1]
        shift, scale, gate = self.modulation(vec)
        h = self.linear1(_modulate(_layer_norm(x), shift, scale))
        qkv = h[..., :3 * d].unflatten(-1, (3, self.cfg.num_heads, d // self.cfg.num_heads))
        with span("sonar.rope"):
            _qk_norm_rope(qkv[:, :, :2], [(slice(None), self.norm.query_norm.scale,
                                           self.norm.key_norm.scale)], *pe)
        with span("sonar.attention"):
            attn = fused_attention(qkv, "unet")
        out = self.linear2(torch.cat([attn, _gelu(h[..., 3 * d:])], dim=-1))
        return x + gate[:, None, :] * out


class LastLayer(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.hidden_size
        self.linear = nn.Linear(d, cfg.out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=-1)
        return self.linear(_modulate(_layer_norm(x), shift, scale))


class Flux(nn.Module):
    """The velocity of latent ``x`` (B, C, H, W) at flow time ``timesteps``
    (B,), given the prompt's T5 encoding ``context`` (B, L, context_in_dim),
    its pooled CLIP vector ``y`` (B, vec_in_dim) and the distilled guidance
    value ``guidance`` (B,)."""

    def __init__(self, cfg: FluxConfig = FluxConfig()):
        super().__init__()
        if sum(cfg.axes_dim) != cfg.head_dim:
            raise ValueError(f"axes_dim {cfg.axes_dim} must sum to the head width "
                             f"{cfg.head_dim}")
        self.cfg = cfg
        d = cfg.hidden_size
        self.img_in = nn.Linear(cfg.in_channels, d)
        self.time_in = MLPEmbedder(256, d)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, d)
        self.guidance_in = MLPEmbedder(256, d)
        self.txt_in = nn.Linear(cfg.context_in_dim, d)
        self.double_blocks = nn.ModuleList(DoubleStreamBlock(cfg) for _ in range(cfg.depth))
        self.single_blocks = nn.ModuleList(SingleStreamBlock(cfg)
                                           for _ in range(cfg.depth_single_blocks))
        self.final_layer = LastLayer(cfg)

    def forward(self, x, timesteps, *, context, y, guidance):
        cfg = self.cfg
        dt = cfg.dtype
        tok, hp, wp = _patchify(x.to(dt))
        img = self.img_in(tok)
        vec = self.time_in(timestep_embedding(timesteps).to(dt))
        vec = vec + self.guidance_in(timestep_embedding(guidance).to(dt))
        vec = vec + self.vector_in(y.to(dt))
        txt = self.txt_in(context.to(dt))
        nt = txt.shape[1]
        pe = _rope_table(hp, wp, nt, tuple(cfg.axes_dim), cfg.theta, x.device)
        for blk in self.double_blocks:
            with span("sonar.flux.double"):
                img, txt = blk(img, txt, vec, pe)
        h = torch.cat([txt, img], dim=1)
        for blk in self.single_blocks:
            with span("sonar.flux.single"):
                h = blk(h, vec, pe)
        out = self.final_layer(h[:, nt:], vec)
        return _unpatchify(out, hp, wp).to(x.dtype)


@torch.no_grad()
def init_flux_params(generator: torch.Generator, cfg: FluxConfig = FluxConfig(),
                     device=None) -> Flux:
    """A FLUX model with random weights drawn from ``generator`` (a CPU
    generator): every linear weight normal with std ``1/sqrt(din)``, biases
    zero, the q/k norms' scales one. ``device=None`` means the card, and
    without one this raises before any weight is drawn."""
    device = default_device(device)
    torch.empty(0, device=device)
    with torch.device("meta"):
        model = Flux(cfg)
    model = model.to_empty(device="cpu")
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(m.weight.shape[1]))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.scale.fill_(1.0)
    return model.to(device=device, dtype=cfg.dtype).eval()


def make_flux_denoiser(model: Flux, *, context: torch.Tensor, y: torch.Tensor,
                       guidance: float, prediction="const",
                       timestep_fn: Callable | None = None) -> Callable:
    """Wrap FLUX into the sampler's denoiser protocol
    ``model(x, sigma_batch) -> denoised`` (the contract of
    :func:`~sonar_tpu_torch.models.dit.make_dit_denoiser`) with one
    prompt's encodings bound, as ComfyUI bakes the conditioning in:
    ``context`` (1 or B, L, context_in_dim) and ``y`` (1 or B, vec_in_dim),
    broadcast over the call's rows, and the distilled ``guidance`` value.
    The guidance lives in the network, so a step is one unguided call.

    ``prediction`` is ``"const"`` (FLUX's velocity) by default. The network
    is conditioned on ``timestep_fn`` of the float32 sigma batch (default:
    sigma itself, which is what the port's ``Flow(multiplier=1.0).timestep``
    gives: the time embedding multiplies by 1000 inside, as FLUX does).
    ``model`` may be any callable taking ``(x, t, context=, y=,
    guidance=)``. Runs without autograd."""
    from .prediction import get_prediction

    pred = get_prediction(prediction)

    @torch.no_grad()
    def denoiser(x, sigma, **kw):
        b = x.shape[0]
        sb32 = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sb32 = sb32.reshape(-1).expand(b)
        s4 = sb32.to(x.dtype).reshape(-1, 1, 1, 1)
        cond = sb32 if timestep_fn is None else timestep_fn(sb32)
        g = torch.full((b,), float(guidance), dtype=torch.float32, device=x.device)
        out = model(pred.calculate_input(s4, x), cond,
                    context=context.expand(b, *context.shape[1:]),
                    y=y.expand(b, *y.shape[1:]), guidance=g)
        return pred.calculate_denoised(s4, out, x)

    return denoiser
