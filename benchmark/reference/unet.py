"""The plain reference of the ``unet`` family: the latent-diffusion UNet
(ADM-style residual blocks with a sigma embedding, self-attention at the
configured levels, skip connections) as one function over a dictionary of
weights, in plain PyTorch.

Written from the JAX package's ``sonar_tpu/models/unet.py`` (the pattern
the port follows), with none of the program's code: convolutions pad as
XLA's "SAME" (a stride-2 3×3 conv on an even size pads 0 before and 1
after), group norm takes the largest group count up to ``norm_groups`` that
divides the channels (eps 1e-5), attention splits qkv as ``(b, n, 3, heads,
d)`` and takes its logits and softmax in float32, and the sigma embedding's
angles are float32.

The weights are named as the port's module names its parameters, so the
benchmark can hand one set of tensors to both sides. :func:`param_specs`
says what each weight is drawn as (the benchmark's own scheme): a conv or
dense weight normal with std ``1/√fan_in``, which keeps a layer's output
at its input's size. No layer is scaled down, as a zero-initialised
residual branch or output would be, so that every layer moves the final
latent the check compares; biases and norm affines are small and random,
so the comparison sees them too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BIAS_STD = 0.02
NORM_STD = 0.05


def _groups(c: int, groups: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _walk(cfg):
    """Yield ``(kind, name, shapes)`` for every layer of the network, in the
    order of the port's parameters: kind ``conv`` (cout, cin, k), ``dense``
    (dout, din) or ``norm`` (channels)."""
    ch = cfg["model_channels"]
    cemb = 4 * ch
    mult = cfg["channel_mult"]
    att = set(cfg["attention_levels"])

    def res(prefix, cin, cout):
        yield "norm", f"{prefix}.norm1", (cin,)
        yield "conv", f"{prefix}.conv1", (cout, cin, 3)
        yield "dense", f"{prefix}.emb", (cout, cemb)
        yield "norm", f"{prefix}.norm2", (cout,)
        yield "conv", f"{prefix}.conv2", (cout, cout, 3)
        if cin != cout:
            yield "conv", f"{prefix}.skip", (cout, cin, 1)

    def attn(prefix, c):
        yield "norm", f"{prefix}.norm", (c,)
        yield "dense", f"{prefix}.qkv", (3 * c, c)
        yield "dense", f"{prefix}.proj", (c, c)

    yield "dense", "time_mlp.fc1", (cemb, ch)
    yield "dense", "time_mlp.fc2", (cemb, cemb)
    yield "conv", "conv_in", (ch, cfg["in_channels"], 3)
    skips, cur = [ch], ch
    for level, m in enumerate(mult):
        cout = ch * m
        for j in range(cfg["num_res_blocks"]):
            yield from res(f"down.{level}.blocks.{j}.res", cur, cout)
            if level in att:
                yield from attn(f"down.{level}.blocks.{j}.attn", cout)
            cur = cout
            skips.append(cur)
        if level != len(mult) - 1:
            yield "conv", f"down.{level}.downsample", (cur, cur, 3)
            skips.append(cur)
    yield from res("mid.res1", cur, cur)
    yield from attn("mid.attn", cur)
    yield from res("mid.res2", cur, cur)
    for k, level in enumerate(reversed(range(len(mult)))):
        cout = ch * mult[level]
        for j in range(cfg["num_res_blocks"] + 1):
            yield from res(f"up.{k}.blocks.{j}.res", cur + skips.pop(), cout)
            if level in att:
                yield from attn(f"up.{k}.blocks.{j}.attn", cout)
            cur = cout
        if level != 0:
            yield "conv", f"up.{k}.upsample", (cur, cur, 3)
    yield "norm", "norm_out", (cur,)
    yield "conv", "conv_out", (cfg["out_channels"], cur, 3)


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(name, shape, mean, std)`` of every weight: each is drawn as
    ``mean + std·N(0, 1)``."""
    out = []
    for kind, name, s in _walk(cfg):
        if kind == "norm":
            out += [(f"{name}.weight", s, 1.0, NORM_STD), (f"{name}.bias", s, 0.0, NORM_STD)]
        elif kind == "conv":
            cout, cin, k = s
            out += [(f"{name}.weight", (cout, cin, k, k), 0.0, 1 / math.sqrt(cin * k * k)),
                    (f"{name}.bias", (cout,), 0.0, BIAS_STD)]
        else:
            dout, din = s
            out += [(f"{name}.weight", (dout, din), 0.0, 1 / math.sqrt(din)),
                    (f"{name}.bias", (dout,), 0.0, BIAS_STD)]
    return out


def sigma_embedding(sigma: torch.Tensor, ch: int) -> torch.Tensor:
    """Fourier features of log σ / 4, cosines first, angles in float32."""
    half = ch // 2
    logs = torch.log(torch.clamp(sigma.float(), min=1e-10)) / 4.0
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=sigma.device)
                      * (-math.log(10000.0) / max(half - 1, 1)))
    ang = logs[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def network(p: dict, cfg, x: torch.Tensor, sigma: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """The network's epsilon for ``x`` (B, C, H, W) at the sigma batch
    ``sigma`` (B,), computed in ``dtype`` (logits, softmax and the embedding's
    angles in float32), returned in float32."""
    w = {k: v.to(dtype) for k, v in p.items()}
    groups = cfg["norm_groups"]

    def conv(h, name, stride=1):
        wt = w[f"{name}.weight"]
        k = wt.shape[-1]
        if stride == 1:
            return F.conv2d(h, wt, w[f"{name}.bias"], padding=k // 2)
        pads = []
        for size in (h.shape[-1], h.shape[-2]):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(h, pads), wt, w[f"{name}.bias"], stride=stride)

    def dense(h, name):
        return F.linear(h, w[f"{name}.weight"], w[f"{name}.bias"])

    def norm(h, name):
        c = h.shape[1]
        return F.group_norm(h, _groups(c, groups), w[f"{name}.weight"], w[f"{name}.bias"],
                            eps=1e-5)

    def res(h, emb, name):
        y = conv(F.silu(norm(h, f"{name}.norm1")), f"{name}.conv1")
        y = y + dense(F.silu(emb), f"{name}.emb")[:, :, None, None]
        y = conv(F.silu(norm(y, f"{name}.norm2")), f"{name}.conv2")
        return y + (conv(h, f"{name}.skip") if f"{name}.skip.weight" in w else h)

    def attn(h, name):
        b, c, hh, ww = h.shape
        n, heads = hh * ww, cfg["num_heads"]
        y = norm(h, f"{name}.norm").reshape(b, c, n).transpose(1, 2)
        q, k, v = dense(y, f"{name}.qkv").reshape(b, n, 3, heads, c // heads).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(c // heads)
        a = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, c)
        return h + dense(out, f"{name}.proj").transpose(1, 2).reshape(b, c, hh, ww)

    mult, att = cfg["channel_mult"], set(cfg["attention_levels"])
    emb = sigma_embedding(sigma, cfg["model_channels"]).to(dtype)
    emb = dense(F.silu(dense(emb, "time_mlp.fc1")), "time_mlp.fc2")
    h = conv(x.to(dtype), "conv_in")
    skips = [h]
    for level in range(len(mult)):
        for j in range(cfg["num_res_blocks"]):
            h = res(h, emb, f"down.{level}.blocks.{j}.res")
            if level in att:
                h = attn(h, f"down.{level}.blocks.{j}.attn")
            skips.append(h)
        if level != len(mult) - 1:
            h = conv(h, f"down.{level}.downsample", stride=2)
            skips.append(h)
    h = res(h, emb, "mid.res1")
    h = attn(h, "mid.attn")
    h = res(h, emb, "mid.res2")
    for k, level in enumerate(reversed(range(len(mult)))):
        for j in range(cfg["num_res_blocks"] + 1):
            h = res(torch.cat([h, skips.pop()], dim=1), emb, f"up.{k}.blocks.{j}.res")
            if level in att:
                h = attn(h, f"up.{k}.blocks.{j}.attn")
        if level != 0:
            h = conv(F.interpolate(h, scale_factor=2, mode="nearest"), f"up.{k}.upsample")
    h = conv(F.silu(norm(h, "norm_out")), "conv_out")
    return h.float()
