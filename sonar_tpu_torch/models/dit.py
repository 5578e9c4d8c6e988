"""Diffusion-Transformer (DiT) denoiser as a PyTorch ``nn.Module`` (port of
``sonar_tpu.models.dit``, single device).

An adaLN DiT: patch embed with a 2D sin-cos position table, a sigma MLP on
the UNet's Fourier features, ``depth`` blocks (attention and an MLP, each
modulated and gated by the conditioning), a final adaLN and a linear head.
Each block's MLP is dense or, with ``num_experts > 0``, a Switch top-1
mixture of experts whose expert weights are ``(E, din, dout)`` parameters
used in ``einsum``. The JAX package stacks block parameters on a leading
``depth`` axis for ``lax.scan``; the port keeps an ``nn.ModuleList``, and
:func:`dit_params_from_jax` unstacks the JAX tree into ``blocks.<i>.…``.

What must match XLA and needs care in PyTorch:

- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- the layer norm has no affine, eps 1e-6, ddof-0 statistics in float32;
- the packed qkv is head-major: feature ``h·3dh + {q,k,v}·dh + i``;
- attention logits and softmax are float32 under bf16 compute (q and k are
  upcast before the product, whose bf16 products are exact in float32), and
  the softmax is cast to the compute dtype before the product with v;
- tokens are laid out (b, hp, wp, ph, pw, c), as ``_patchify`` does;
- the sigma embedding's angles are float32 (the UNet's ``_sigma_embedding``).

The DiT holds no hand-written kernel: its products, norms and softmax are
PyTorch operators. The sampler around it launches the port's kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.misc import default_device
from .unet import Dense, _sigma_embedding


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 4
    patch_size: int = 2
    hidden: int = 256
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: int = 4
    # num_experts > 0 swaps every block's MLP for a Switch-style top-1
    # mixture of experts (einsum dispatch/combine, static per-sample capacity)
    num_experts: int = 0
    capacity_factor: float = 1.25
    dtype: Any = torch.float32

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels

    def expert_capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(self.capacity_factor * n_tokens / self.num_experts))


class ExpertDense(nn.Module):
    """E dense layers side by side: ``weight`` (E, din, dout), ``bias`` (E, dout),
    in the JAX layout (the products are einsums, not ``F.linear``)."""

    def __init__(self, n_experts: int, din: int, dout: int, init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_experts, din, dout))
        self.bias = nn.Parameter(torch.empty(n_experts, dout))
        self.init_scale = init_scale


@functools.lru_cache(maxsize=16)
def _pos_embed(hp: int, wp: int, d: int, dtype, device) -> torch.Tensor:
    """2D sin-cos position table (hp·wp, d), built once per size in float32
    on the host and cached on ``device``; zero-padded where d is not a
    multiple of 4."""
    q = d // 4
    omega = torch.exp(torch.arange(q, dtype=torch.float32)
                      * (-math.log(10000.0) / max(q - 1, 1)))
    ys = torch.arange(hp, dtype=torch.float32)[:, None] * omega[None, :]
    xs = torch.arange(wp, dtype=torch.float32)[:, None] * omega[None, :]
    ye = torch.cat([torch.sin(ys), torch.cos(ys)], -1)  # (hp, 2q)
    xe = torch.cat([torch.sin(xs), torch.cos(xs)], -1)  # (wp, 2q)
    grid = torch.cat([ye[:, None, :].expand(hp, wp, 2 * q),
                      xe[None, :, :].expand(hp, wp, 2 * q)], -1)
    emb = F.pad(grid.reshape(hp * wp, 4 * q), (0, d - 4 * q))
    return emb.to(device=device, dtype=dtype)


def _layer_norm(x):
    """Affine-free layer norm (adaLN supplies shift and scale), statistics in
    float32 whatever the compute dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _patchify(x, patch: int):
    b, c, hh, ww = x.shape
    hp, wp = hh // patch, ww // patch
    x = x.reshape(b, c, hp, patch, wp, patch).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, hp * wp, patch * patch * c), hp, wp


def _unpatchify(tok, hp: int, wp: int, patch: int, c: int):
    x = tok.reshape(tok.shape[0], hp, wp, patch, patch, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(tok.shape[0], c, hp * patch, wp * patch)


class Block(nn.Module):
    """One adaLN DiT block; ``forward`` returns ``(h, aux)``, aux the Switch
    load-balance loss of an MoE block and None for a dense one."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, f, e = cfg.hidden, cfg.mlp_ratio * cfg.hidden, cfg.num_experts
        self.cfg = cfg
        # small-random adaLN weights and zero biases: near-identity blocks at
        # init that keep the compute path non-degenerate (as the JAX init)
        self.ada = Dense(d, 6 * d, init_scale=1e-2)
        self.qkv = Dense(d, 3 * d)
        self.attn_out = Dense(d, d, init_scale=1e-2)
        if e:
            self.router = Dense(d, e, init_scale=1e-2)
            self.mlp_in = ExpertDense(e, d, f)
            self.mlp_out = ExpertDense(e, f, d, init_scale=1e-2)
        else:
            self.mlp_in = Dense(d, f)
            self.mlp_out = Dense(f, d, init_scale=1e-2)

    def attention(self, x):
        b, n, d = x.shape
        heads = self.cfg.num_heads
        dh = d // heads
        qkv = self.qkv(x).reshape(b, n, heads, 3, dh)  # head-major packing
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, dh)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        att = torch.softmax(logits / math.sqrt(dh), dim=-1)
        out = torch.matmul(att.to(x.dtype), v)
        return self.attn_out(out.transpose(1, 2).reshape(b, n, d))

    def moe_mlp(self, x):
        """Switch top-1 routing per sample: each sample's tokens compete for a
        static per-expert capacity ``C = ceil(cf·N/E)``; a token's slot is its
        rank among the sample's tokens routed to its expert (cumsum of the
        one-hot), and tokens past the capacity drop out (only their residual
        path remains). Returns ``(y, aux)``, aux = ``E · Σ_e f_e·P_e`` (≥ 1,
        1 when balanced)."""
        b, n, d = x.shape
        e = self.cfg.num_experts
        c = self.cfg.expert_capacity(n)
        probs = torch.softmax(self.router(x).float(), dim=-1)          # (B,N,E)
        gate = probs.amax(dim=-1)                                      # (B,N)
        onehot = F.one_hot(probs.argmax(dim=-1), e).float()            # (B,N,E)
        aux = e * torch.sum(onehot.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
        keep = (pos >= 0.0) & (pos < c)
        slot = F.one_hot(pos.clamp(0, c - 1).long(), c).float()       # (B,N,E,C)
        dispatch = (slot * keep[..., None]).to(x.dtype)
        combine = dispatch * gate[..., None, None].to(x.dtype)
        xin = torch.einsum("bnec,bnd->ebcd", dispatch, x)              # (E,B,C,D)
        w_in, w_out = self.mlp_in, self.mlp_out
        hmid = _gelu(torch.einsum("ebcd,edf->ebcf", xin, w_in.weight)
                     + w_in.bias[:, None, None, :])
        yout = (torch.einsum("ebcf,efd->ebcd", hmid, w_out.weight)
                + w_out.bias[:, None, None, :])
        return torch.einsum("bnec,ebcd->bnd", combine, yout), aux

    def forward(self, h, emb):
        mod = self.ada(F.silu(emb))
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        h = h + g_a[:, None, :] * self.attention(_modulate(_layer_norm(h), sh_a, sc_a))
        y = _modulate(_layer_norm(h), sh_m, sc_m)
        if self.cfg.num_experts:
            y, aux = self.moe_mlp(y)
        else:
            y, aux = self.mlp_out(_gelu(self.mlp_in(y))), None
        return h + g_m[:, None, :] * y, aux


class DiT(nn.Module):
    """Predicts epsilon for latent ``x`` (B,C,H,W) at noise level ``sigma`` (B,)."""

    def __init__(self, cfg: DiTConfig = DiTConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden
        self.patch_embed = Dense(cfg.patch_dim, d)
        self.sigma_mlp = nn.ModuleDict({"fc1": Dense(d, d), "fc2": Dense(d, d)})
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        # DiT zero-inits the output head; a small scale keeps the untrained
        # model's output usable for tests (as the JAX init)
        self.final = nn.ModuleDict({"ada": Dense(d, 2 * d, init_scale=1e-2),
                                    "out": Dense(d, cfg.patch_dim, init_scale=1e-2)})

    def forward(self, x, sigma, *, return_aux: bool = False):
        """``return_aux=True`` also returns the mean of the blocks' MoE
        load-balance losses (a float32 zero for a dense DiT)."""
        cfg = self.cfg
        dt = cfg.dtype
        tok, hp, wp = _patchify(x.to(dt), cfg.patch_size)
        h = self.patch_embed(tok) + _pos_embed(hp, wp, cfg.hidden, dt, x.device)
        s = self.sigma_mlp
        emb = s["fc2"](F.silu(s["fc1"](_sigma_embedding(sigma, cfg.hidden, dt))))
        auxs = []
        for blk in self.blocks:
            h, aux = blk(h, emb)
            auxs.append(aux)
        shift, scale = self.final["ada"](F.silu(emb)).chunk(2, dim=-1)
        tok = self.final["out"](_modulate(_layer_norm(h), shift, scale))
        eps = _unpatchify(tok, hp, wp, cfg.patch_size, cfg.in_channels).to(x.dtype)
        if not return_aux:
            return eps
        if cfg.num_experts:
            return eps, torch.stack(auxs).mean()
        return eps, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def init_dit_params(generator: torch.Generator, cfg: DiTConfig = DiTConfig(),
                    device=None) -> DiT:
    """A DiT with random weights drawn from ``generator`` (a CPU generator):
    every dense and expert weight normal with std ``init_scale/sqrt(din)``,
    biases zero, as in the JAX init. The weights are drawn on the host and
    moved to ``device`` once; ``device=None`` means the card, and without one
    this raises before any weight is drawn."""
    device = default_device(device)
    torch.empty(0, device=device)
    with torch.device("meta"):  # skip torch's default init and its global RNG
        model = DiT(cfg)
    model = model.to_empty(device="cpu")
    for m in model.modules():
        if isinstance(m, (Dense, ExpertDense)):
            din = m.weight.shape[1]  # Linear (dout, din); experts (E, din, dout)
            std = m.init_scale * math.sqrt(1.0 / din)
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            m.bias.zero_()
    return model.to(device=device, dtype=cfg.dtype).eval()


def dit_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Map the JAX DiT parameter pytree (leaves as numpy arrays) onto
    :class:`DiT`'s ``state_dict``: the stacked ``blocks`` leaves are split
    along their leading ``depth`` axis into ``blocks.<i>.…``; dense weights
    (din, dout) become ``nn.Linear`` weights (dout, din); expert weights
    (E, din, dout) and biases are copied as they are."""
    out: dict[str, torch.Tensor] = {}

    def put(path, a):
        *parent, leaf = path
        if leaf == "w" and a.ndim == 2:
            a = a.T
        name = {"w": "weight", "b": "bias"}[leaf]
        out[".".join((*parent, name))] = torch.tensor(np.ascontiguousarray(a))

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, str(k)))
        elif path[0] == "blocks":
            a = np.asarray(node)
            for i in range(a.shape[0]):
                put(("blocks", str(i), *path[1:]), a[i])
        else:
            put(path, np.asarray(node))

    walk(tree, ())
    return out


def dit_apply(model: DiT, x: torch.Tensor, sigma: torch.Tensor, *,
              return_aux: bool = False):
    """Predict epsilon for latent ``x`` (B,C,H,W) at noise level ``sigma``
    (B,); ``return_aux=True`` also returns the mean MoE load-balance loss."""
    return model(x, sigma, return_aux=return_aux)


def make_dit_denoiser(model: DiT, *, prediction="eps", params_kwarg: str = "params",
                      timestep_fn: Callable | None = None) -> Callable:
    """Wrap the DiT into the sampler's denoiser protocol
    ``model(x, sigma_batch) -> denoised`` (the contract of
    :func:`~sonar_tpu_torch.models.unet.make_denoiser`).

    ``prediction`` names what the raw output means: ``"eps"`` (default),
    ``"v"``, ``"x0"``, or ``"const"``/``"flow"`` for a rectified-flow DiT
    (pair with ``timestep_fn=cfg.Flow().timestep``, so the embedding sees
    ``sigma * 1000``, and sample with ``ancestral_mode="rf"``). The network
    is conditioned on the float32 sigma batch; the latent arithmetic runs in
    ``x.dtype``. A call with ``params_kwarg=`` a dict of tensors keyed as the
    module's ``state_dict`` runs on those weights through
    ``torch.func.functional_call``. Runs without autograd."""
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
        out = model(xin, cond) if p is None else torch.func.functional_call(model, p, (xin, cond))
        return pred.calculate_denoised(s4, out, x)

    return denoiser
