"""The plain reference of the ``dit`` family: the diffusion transformer of
Peebles & Xie (arXiv:2212.09748) with adaLN-Zero blocks, conditioned on
sigma alone, as one function over a dictionary of weights, in plain PyTorch.

Written from the paper and the JAX package's ``sonar_tpu/models/dit.py``
(the pattern the port follows), with none of the program's code:

- tokens are the latent's p×p patches laid out (b, hp, wp, ph, pw, c),
  embedded by one dense layer, plus a 2D sin-cos position table (the row's
  sin and cos, then the column's, ``d/4`` frequencies each);
- the conditioning is the sigma embedding (Fourier features of log σ/4,
  angles in float32) through a two-layer SiLU MLP;
- a block modulates an affine-free layer norm (eps 1e-6, float32
  statistics) with six adaLN vectors, runs multi-head attention with a
  head-major packed qkv (feature ``h·3dh + {q,k,v}·dh + i``) and float32
  logits and softmax, and a tanh-GELU MLP, each gated into the residual;
- the head is a final adaLN and a dense layer back to patches.

The weights are named as the port's module names its parameters.
:func:`param_specs` says how each is drawn (the benchmark's own scheme, as the
UNet's: std ``1/√din`` on every layer, adaLN, the gated outputs and the
head included, so that every block moves the final latent; small random
biases).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .unet import BIAS_STD, sigma_embedding


def _dense_layers(cfg):
    d, pd = cfg["hidden"], cfg["patch_size"] ** 2 * cfg["in_channels"]
    f = cfg["mlp_ratio"] * d
    yield "patch_embed", d, pd
    yield "sigma_mlp.fc1", d, d
    yield "sigma_mlp.fc2", d, d
    for i in range(cfg["depth"]):
        yield f"blocks.{i}.ada", 6 * d, d
        yield f"blocks.{i}.qkv", 3 * d, d
        yield f"blocks.{i}.attn_out", d, d
        yield f"blocks.{i}.mlp_in", f, d
        yield f"blocks.{i}.mlp_out", d, f
    yield "final.ada", 2 * d, d
    yield "final.out", pd, d


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(name, shape, mean, std)`` of every weight."""
    out = []
    for name, dout, din in _dense_layers(cfg):
        out += [(f"{name}.weight", (dout, din), 0.0, 1 / math.sqrt(din)),
                (f"{name}.bias", (dout,), 0.0, BIAS_STD)]
    return out


def pos_embed(hp: int, wp: int, d: int, device) -> torch.Tensor:
    q = d // 4
    omega = torch.exp(torch.arange(q, dtype=torch.float32, device=device)
                      * (-math.log(10000.0) / max(q - 1, 1)))
    ys = torch.arange(hp, dtype=torch.float32, device=device)[:, None] * omega
    xs = torch.arange(wp, dtype=torch.float32, device=device)[:, None] * omega
    row = torch.cat([torch.sin(ys), torch.cos(ys)], -1)[:, None, :].expand(hp, wp, 2 * q)
    col = torch.cat([torch.sin(xs), torch.cos(xs)], -1)[None, :, :].expand(hp, wp, 2 * q)
    table = torch.cat([row, col], -1).reshape(hp * wp, 4 * q)
    return F.pad(table, (0, d - 4 * q))


def network(p: dict, cfg, x: torch.Tensor, sigma: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """The network's epsilon for ``x`` (B, C, H, W) at the sigma batch
    ``sigma`` (B,), computed in ``dtype`` (norm statistics, logits, softmax
    and the embedding's angles in float32), returned in float32."""
    w = {k: v.to(dtype) for k, v in p.items()}
    d, heads, ps = cfg["hidden"], cfg["num_heads"], cfg["patch_size"]
    dh = d // heads
    b, c, hh, ww = x.shape
    hp, wp = hh // ps, ww // ps

    def dense(h, name):
        return F.linear(h, w[f"{name}.weight"], w[f"{name}.bias"])

    def ln(h):
        return F.layer_norm(h.float(), h.shape[-1:], eps=1e-6).to(dtype)

    def modulate(h, shift, scale):
        return h * (1.0 + scale[:, None, :]) + shift[:, None, :]

    tok = x.to(dtype).reshape(b, c, hp, ps, wp, ps).permute(0, 2, 4, 3, 5, 1)
    tok = tok.reshape(b, hp * wp, ps * ps * c)
    h = dense(tok, "patch_embed") + pos_embed(hp, wp, d, x.device).to(dtype)
    emb = sigma_embedding(sigma, d).to(dtype)
    emb = dense(F.silu(dense(emb, "sigma_mlp.fc1")), "sigma_mlp.fc2")
    n = hp * wp
    for i in range(cfg["depth"]):
        name = f"blocks.{i}"
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = dense(F.silu(emb), f"{name}.ada").chunk(6, dim=-1)
        y = modulate(ln(h), sh_a, sc_a)
        qkv = dense(y, f"{name}.qkv").reshape(b, n, heads, 3, dh)
        q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
        att = torch.matmul(torch.softmax(logits, dim=-1).to(dtype), v)
        att = dense(att.transpose(1, 2).reshape(b, n, d), f"{name}.attn_out")
        h = h + g_a[:, None, :] * att
        y = modulate(ln(h), sh_m, sc_m)
        y = dense(F.gelu(dense(y, f"{name}.mlp_in"), approximate="tanh"), f"{name}.mlp_out")
        h = h + g_m[:, None, :] * y
    shift, scale = dense(F.silu(emb), "final.ada").chunk(2, dim=-1)
    tok = dense(modulate(ln(h), shift, scale), "final.out")
    out = tok.reshape(b, hp, wp, ps, ps, c).permute(0, 5, 1, 3, 2, 4)
    return out.reshape(b, c, hh, ww).float()
