"""The plain reference of the ``flux`` family: FLUX.1's rectified-flow
transformer (double- and single-stream blocks over a joint text and image
sequence, RoPE and q/k RMSNorm), as one function over a dictionary of
weights, in plain PyTorch.

Written from github.com/black-forest-labs/flux (``src/flux/model.py``,
``src/flux/modules/layers.py``, ``src/flux/math.py``), with none of the
program's code:

- tokens are the latent's 2×2 patches, ``b c (h 2) (w 2) -> b (h w) (c 2 2)``;
- ``vec = time_in(temb(t)) + guidance_in(temb(g)) + vector_in(y)``, each
  ``Linear → SiLU → Linear``, ``temb(t) = [cos(1000·t·f), sin(1000·t·f)]``,
  ``f_j = exp(−ln(10⁴)·j/128)``, float32;
- RoPE: text tokens at position (0, 0, 0), image token (r, c) at (0, r, c);
  axis i of width ``a_i`` turns pair j < a_i/2 by ``pos·10⁴^(−2j/a_i)``
  (angles, cosines and sines in float64, stored float32), the pairs being
  adjacent dimensions (2j, 2j+1) of a head, applied in float32 after the
  q/k RMSNorm (float32 statistics, eps 1e-6, cast back, times the scale);
- a double block modulates an affine-free layer norm (eps 1e-6, float32
  statistics) with each stream's (shift, scale, gate) pairs, takes each
  stream's qkv as ``(K H D)``, attends over ``cat(txt, img)``, and adds each
  stream's gated projection and tanh-GELU MLP;
- a single block: ``[qkv | h] = linear1(modulated LN(x))``, attention, and
  ``x + gate·linear2(cat(attn, gelu(h)))``;
- the head drops the text tokens: ``(shift, scale)``, a dense layer back to
  patches.

Departures from BFL's code: attention is plain logits and softmax, the
logits in float32 (BFL calls ``scaled_dot_product_attention``); the prompt's
encodings are not made by T5-XXL and CLIP-L but drawn from the seed as two
more entries of the weights, ``cond.txt`` (1, context_tokens, 4096) and
``cond.y`` (1, 768), N(0, 1), standing in for one prompt encoded once and
cached; the guidance value is the configuration's ``guidance``.

The weights are named as the port's module (and BFL's) names its
parameters. :func:`param_specs` says how each is drawn (the benchmark's own
scheme, as the DiT's: std ``1/√din`` on every dense weight, small random
biases, the q/k norms' scales around 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .unet import BIAS_STD, NORM_STD


def _dense_layers(cfg):
    d, f = cfg["hidden_size"], cfg["mlp_ratio"] * cfg["hidden_size"]
    yield "img_in", d, cfg["in_channels"]
    yield "time_in.in_layer", d, 256
    yield "time_in.out_layer", d, d
    yield "vector_in.in_layer", d, cfg["vec_in_dim"]
    yield "vector_in.out_layer", d, d
    yield "guidance_in.in_layer", d, 256
    yield "guidance_in.out_layer", d, d
    yield "txt_in", d, cfg["context_in_dim"]
    for i in range(cfg["depth"]):
        for s in ("img", "txt"):
            name = f"double_blocks.{i}.{s}"
            yield f"{name}_mod.lin", 6 * d, d
            yield f"{name}_attn.qkv", 3 * d, d
            yield f"{name}_attn.proj", d, d
            yield f"{name}_mlp.0", f, d
            yield f"{name}_mlp.2", d, f
    for i in range(cfg["depth_single_blocks"]):
        name = f"single_blocks.{i}"
        yield f"{name}.linear1", 3 * d + f, d
        yield f"{name}.linear2", d, d + f
        yield f"{name}.modulation.lin", 3 * d, d
    yield "final_layer.linear", cfg["out_channels"], d
    yield "final_layer.adaLN_modulation.1", 2 * d, d


def _norms(cfg):
    for i in range(cfg["depth"]):
        for s in ("img", "txt"):
            yield f"double_blocks.{i}.{s}_attn.norm"
    for i in range(cfg["depth_single_blocks"]):
        yield f"single_blocks.{i}.norm"


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(name, shape, mean, std)`` of every weight, then of the prompt's
    two encodings."""
    out = []
    for name, dout, din in _dense_layers(cfg):
        out += [(f"{name}.weight", (dout, din), 0.0, 1 / math.sqrt(din)),
                (f"{name}.bias", (dout,), 0.0, BIAS_STD)]
    dh = cfg["hidden_size"] // cfg["num_heads"]
    for name in _norms(cfg):
        out += [(f"{name}.query_norm.scale", (dh,), 1.0, NORM_STD),
                (f"{name}.key_norm.scale", (dh,), 1.0, NORM_STD)]
    out += [("cond.txt", (1, cfg["context_tokens"], cfg["context_in_dim"]), 0.0, 1.0),
            ("cond.y", (1, cfg["vec_in_dim"]), 0.0, 1.0)]
    return out


def temb(t: torch.Tensor) -> torch.Tensor:
    freqs = torch.exp(-math.log(10000.0) * torch.arange(128, dtype=torch.float32,
                                                        device=t.device) / 128)
    args = (t.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_angles(hp: int, wp: int, txt: int, axes_dim, theta: float, device):
    """``(cos, sin)`` of every pair of the joint sequence, (n, head_dim/2)."""
    ids = torch.zeros(txt + hp * wp, 3, dtype=torch.float64)
    rows, cols = torch.meshgrid(torch.arange(hp, dtype=torch.float64),
                                torch.arange(wp, dtype=torch.float64), indexing="ij")
    ids[txt:, 1], ids[txt:, 2] = rows.reshape(-1), cols.reshape(-1)
    ang = torch.cat([torch.einsum("n,d->nd", ids[:, i],
                                  1.0 / theta ** (torch.arange(0, a, 2, dtype=torch.float64) / a))
                     for i, a in enumerate(axes_dim)], dim=-1)
    return torch.cos(ang).float().to(device), torch.sin(ang).float().to(device)


def network(p: dict, cfg, x: torch.Tensor, t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The network's velocity for ``x`` (B, C, H, W) at flow time ``t``
    (B,), computed in ``dtype`` (norm statistics, RoPE, logits, softmax and
    the time embedding's angles in float32), returned in float32."""
    w = {k: v.to(dtype) for k, v in p.items()}
    d, heads = cfg["hidden_size"], cfg["num_heads"]
    dh = d // heads
    b, c, hh, ww = x.shape
    hp, wp = hh // 2, ww // 2

    def dense(h, name):
        return F.linear(h, w[f"{name}.weight"], w[f"{name}.bias"])

    def mlp_embed(h, name):
        return dense(F.silu(dense(h, f"{name}.in_layer")), f"{name}.out_layer")

    def ln(h):
        return F.layer_norm(h.float(), h.shape[-1:], eps=1e-6).to(dtype)

    def modulate(h, shift, scale):
        return (1.0 + scale[:, None, :]) * ln(h) + shift[:, None, :]

    def rms(h, scale):
        hf = h.float()
        rrms = torch.rsqrt(torch.mean(hf * hf, dim=-1, keepdim=True) + 1e-6)
        return (hf * rrms).to(dtype) * scale

    cos, sin = rope_angles(hp, wp, cfg["context_tokens"], cfg["axes_dim"], cfg["theta"], x.device)

    def rope(h):  # (b, heads, n, dh)
        hf = h.float().reshape(*h.shape[:-1], dh // 2, 2)
        a, bb = hf[..., 0], hf[..., 1]
        out = torch.stack([cos * a - sin * bb, sin * a + cos * bb], dim=-1)
        return out.reshape(h.shape).to(dtype)

    def split_heads(qkv):  # (b, n, 3d) -> 3 × (b, heads, n, dh)
        q, k, v = qkv.reshape(b, qkv.shape[1], 3, heads, dh).permute(2, 0, 3, 1, 4)
        return q, k, v

    def attention(q, k, v):
        q, k = rope(q), rope(k)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
        out = torch.matmul(torch.softmax(logits, dim=-1).to(dtype), v)
        return out.transpose(1, 2).reshape(b, -1, d)

    tok = x.to(dtype).reshape(b, c, hp, 2, wp, 2).permute(0, 2, 4, 1, 3, 5)
    img = dense(tok.reshape(b, hp * wp, c * 4), "img_in")
    g = torch.full((b,), float(cfg["guidance"]), device=x.device)
    vec = (mlp_embed(temb(t).to(dtype), "time_in") + mlp_embed(temb(g).to(dtype), "guidance_in")
           + mlp_embed(w["cond.y"].expand(b, -1), "vector_in"))
    txt = dense(w["cond.txt"].expand(b, -1, -1), "txt_in")
    nt = txt.shape[1]
    for i in range(cfg["depth"]):
        name = f"double_blocks.{i}"
        mods, qkvs = {}, {}
        for s, h in (("txt", txt), ("img", img)):
            mods[s] = dense(F.silu(vec), f"{name}.{s}_mod.lin").chunk(6, dim=-1)
            q, k, v = split_heads(dense(modulate(h, mods[s][0], mods[s][1]),
                                        f"{name}.{s}_attn.qkv"))
            norm = f"{name}.{s}_attn.norm"
            qkvs[s] = (rms(q, w[f"{norm}.query_norm.scale"]), rms(k, w[f"{norm}.key_norm.scale"]),
                       v)
        att = attention(*(torch.cat([qkvs["txt"][j], qkvs["img"][j]], dim=2) for j in range(3)))
        out = {}
        for s, h, a in (("txt", txt, att[:, :nt]), ("img", img, att[:, nt:])):
            sh1, sc1, g1, sh2, sc2, g2 = mods[s]
            h = h + g1[:, None, :] * dense(a, f"{name}.{s}_attn.proj")
            y = F.gelu(dense(modulate(h, sh2, sc2), f"{name}.{s}_mlp.0"), approximate="tanh")
            out[s] = h + g2[:, None, :] * dense(y, f"{name}.{s}_mlp.2")
        txt, img = out["txt"], out["img"]
    h = torch.cat([txt, img], dim=1)
    for i in range(cfg["depth_single_blocks"]):
        name = f"single_blocks.{i}"
        shift, scale, gate = dense(F.silu(vec), f"{name}.modulation.lin").chunk(3, dim=-1)
        lin1 = dense(modulate(h, shift, scale), f"{name}.linear1")
        q, k, v = split_heads(lin1[..., :3 * d])
        q = rms(q, w[f"{name}.norm.query_norm.scale"])
        k = rms(k, w[f"{name}.norm.key_norm.scale"])
        mlp = F.gelu(lin1[..., 3 * d:], approximate="tanh")
        h = h + gate[:, None, :] * dense(torch.cat([attention(q, k, v), mlp], dim=-1),
                                         f"{name}.linear2")
    shift, scale = dense(F.silu(vec), "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    out = dense(modulate(h[:, nt:], shift, scale), "final_layer.linear")
    out = out.reshape(b, hp, wp, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return out.reshape(b, c, hh, ww).float()
