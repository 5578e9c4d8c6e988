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

Parallel serving (the JAX package's shardings and ``dit_pp_apply``), one
process a rank with the collectives of ``parallel.mesh``:

- :func:`dit_param_shardings` names each parameter's DTensor placements as
  the JAX package's shardings do (Megatron tensor parallelism on ``tp``,
  expert weights on ``ep``, the block stack on ``pp``), and
  :func:`shard_dit_params` keeps this rank's part of each;
- tp: ``qkv`` and ``mlp_in`` are column-parallel (a shard holds whole heads,
  the packing being head-major), ``attn_out`` and a dense ``mlp_out``
  row-parallel: the partial product is summed over tp and the bias added
  once after the sum;
- ep: a rank holds E/ep experts and dispatches to them alone; routing,
  capacity and aux are computed on all E, the same on every rank, and the
  combine is one sum over ep;
- pp: :func:`pp_stage_params` keeps a stage's contiguous blocks, and
  :func:`dit_pp_apply` runs the GPipe schedule, the activations handed
  stage to stage by ``ppermute``;
- dp: a DTensor latent is run on its local rows.

The collectives carry gradients (:mod:`sonar_tpu_torch.parallel.grad`), so
``torch.autograd`` through :func:`dit_apply` under tp or ep and through
:func:`dit_pp_apply` is the sharded backward: pipeline backprop hands each
microbatch's gradient back stage to stage, and the embedding's and head's
gradients come out whole on every stage, as ``jax.grad`` gives them.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel.grad import copy_to, join, ppermute_grad, reduce_from, reduce_from_groups
from ..parallel.mesh import LatentShard
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
        # (mesh, axis) where :func:`shard_dit_params` split this block's
        # weights on tp or its experts on ep; None where they are whole
        self.tp = self.ep = None
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

    def _column(self, dense, x):
        """A column-parallel product: under tp the weight holds this rank's
        output features and the (whole) bias gives their slice. The input and
        the bias are whole on every rank, so their gradients are summed over
        tp."""
        if self.tp is None:
            return dense(x)
        mesh, axis = self.tp
        bias = copy_to(dense.bias, mesh, axis)
        if bias.shape[0] != dense.weight.shape[0]:
            bias = bias.chunk(mesh.size(mesh.mesh_dim_names.index(axis)))[
                mesh.get_local_rank(axis)]
        return F.linear(copy_to(x, mesh, axis), dense.weight, bias)

    def _row(self, dense, x):
        """A row-parallel product: under tp the rank's partial product is
        summed over tp, then the bias is added once."""
        if self.tp is None:
            return dense(x)
        return reduce_from(F.linear(x, dense.weight), *self.tp) + dense.bias

    def attention(self, x):
        b, n, d = x.shape
        dh = d // self.cfg.num_heads
        qkv = self._column(self.qkv, x)
        heads = qkv.shape[-1] // (3 * dh)  # this rank's heads under tp
        qkv = qkv.reshape(b, n, heads, 3, dh)  # head-major packing
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, dh)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        att = torch.softmax(logits / math.sqrt(dh), dim=-1)
        out = torch.matmul(att.to(x.dtype), v)
        return self._row(self.attn_out, out.transpose(1, 2).reshape(b, n, heads * dh))

    def moe_mlp(self, x, dp=None):
        """Switch top-1 routing per sample: each sample's tokens compete for a
        static per-expert capacity ``C = ceil(cf·N/E)``; a token's slot is its
        rank among the sample's tokens routed to its expert (cumsum of the
        one-hot), and tokens past the capacity drop out (only their residual
        path remains). Returns ``(y, aux)``, aux = ``E · Σ_e f_e·P_e`` (≥ 1,
        1 when balanced).

        Under ep this rank's experts are ``mlp_in.weight``'s E/ep; it
        dispatches to them alone and the combine is summed over ep. ``dp``
        (process groups, global rows): ``x`` is a shard of the batch, and
        ``f`` and ``P`` are means over the whole batch."""
        b, n, d = x.shape
        e = self.cfg.num_experts
        c = self.cfg.expert_capacity(n)
        probs = torch.softmax(self.router(x).float(), dim=-1)          # (B,N,E)
        gate = probs.amax(dim=-1)                                      # (B,N)
        onehot = F.one_hot(probs.argmax(dim=-1), e).float()            # (B,N,E)
        if dp is None:
            f_e, p_e = onehot.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
        else:
            # every rank computes the whole batch's aux; its gradient on a
            # rank is its own tokens' share, summed over dp with the rest
            groups, rows = dp
            sums = reduce_from_groups(
                torch.stack([onehot.sum(dim=(0, 1)), probs.sum(dim=(0, 1))]), groups) / (rows * n)
            f_e, p_e = sums[0], sums[1]
        aux = e * torch.sum(f_e * p_e)
        pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
        keep = (pos >= 0.0) & (pos < c)
        slot = F.one_hot(pos.clamp(0, c - 1).long(), c).float()       # (B,N,E,C)
        dispatch = (slot * keep[..., None]).to(x.dtype)
        w_in, w_out = self.mlp_in, self.mlp_out
        if self.ep is not None:  # this rank's experts: [lo, lo + E/ep)
            mesh, axis = self.ep
            lo = mesh.get_local_rank(axis) * w_in.weight.shape[0]
            dispatch = dispatch[:, :, lo:lo + w_in.weight.shape[0]]
            # whole on every rank, each rank's experts take their share
            x, gate = copy_to(x, mesh, axis), copy_to(gate, mesh, axis)
        combine = dispatch * gate[..., None, None].to(x.dtype)
        xin = torch.einsum("bnec,bnd->ebcd", dispatch, x)              # (E,B,C,D)
        hmid = _gelu(torch.einsum("ebcd,edf->ebcf", xin, w_in.weight)
                     + w_in.bias[:, None, None, :])
        yout = (torch.einsum("ebcf,efd->ebcd", hmid, w_out.weight)
                + w_out.bias[:, None, None, :])
        y = torch.einsum("bnec,ebcd->bnd", combine, yout)
        return (y if self.ep is None else reduce_from(y, *self.ep)), aux

    def forward(self, h, emb, dp=None):
        mod = self.ada(F.silu(emb))
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        h = h + g_a[:, None, :] * self.attention(_modulate(_layer_norm(h), sh_a, sc_a))
        y = _modulate(_layer_norm(h), sh_m, sc_m)
        if self.cfg.num_experts:
            y, aux = self.moe_mlp(y, dp)
        else:
            y, aux = self._row(self.mlp_out, _gelu(self._column(self.mlp_in, y))), None
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
        # (stage, stages) of a module that :func:`pp_stage_params` staged
        self.pp_stage = None

    def embed(self, x, sigma):
        """Patchify, embed and condition: ``(h, emb, hp, wp)``."""
        cfg = self.cfg
        dt = cfg.dtype
        tok, hp, wp = _patchify(x.to(dt), cfg.patch_size)
        h = self.patch_embed(tok) + _pos_embed(hp, wp, cfg.hidden, dt, x.device)
        s = self.sigma_mlp
        emb = s["fc2"](F.silu(s["fc1"](_sigma_embedding(sigma, cfg.hidden, dt))))
        return h, emb, hp, wp

    def run_blocks(self, h, emb, dp=None):
        """The blocks this module holds: ``(h, mean aux)``, aux None for a
        dense DiT."""
        auxs = []
        for blk in self.blocks:
            h, aux = blk(h, emb, dp)
            auxs.append(aux)
        return h, (torch.stack(auxs).mean() if self.cfg.num_experts else None)

    def head(self, h, emb, hp: int, wp: int, dtype):
        cfg = self.cfg
        shift, scale = self.final["ada"](F.silu(emb)).chunk(2, dim=-1)
        tok = self.final["out"](_modulate(_layer_norm(h), shift, scale))
        return _unpatchify(tok, hp, wp, cfg.patch_size, cfg.in_channels).to(dtype)

    def forward(self, x, sigma, *, return_aux: bool = False, dp=None):
        """``return_aux=True`` also returns the mean of the blocks' MoE
        load-balance losses (a float32 zero for a dense DiT). ``dp``
        (process groups, global rows): ``x`` is a shard of the batch, and the
        aux is the whole batch's."""
        if self.pp_stage is not None:
            raise ValueError("this DiT holds one pipeline stage's blocks: run it with "
                             "dit_pp_apply")
        h, emb, hp, wp = self.embed(x, sigma)
        h, aux = self.run_blocks(h, emb, dp)
        eps = self.head(h, emb, hp, wp, x.dtype)
        if not return_aux:
            return eps
        if aux is not None:
            return eps, aux
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


def _local_rows(x, sigma):
    """``(x rows, sigma rows, dp, wrap)`` of a DTensor latent split on its
    batch (``dp`` = the batch axes' process groups and the global row count,
    ``wrap`` makes a result a DTensor laid out as ``x``); a plain latent as
    it is, None and the identity. ``sigma`` is the whole batch's (or one
    value), or a DTensor split as ``x``."""
    if not isinstance(x, DTensor):
        return x, sigma, None, lambda out: out
    shard = LatentShard.of(x)
    if any(shard.local_shape[d] != shard.global_shape[d] for d in range(1, x.ndim)):
        raise NotImplementedError(f"the DiT splits a latent on its batch only, not "
                                  f"{x.placements}")
    b0, bl = shard.offset[0], shard.local_shape[0]
    if isinstance(sigma, DTensor):
        sigma = sigma.to_local()
    elif torch.as_tensor(sigma).ndim and torch.as_tensor(sigma).shape[0] == x.shape[0] > 1:
        sigma = sigma[b0:b0 + bl]
    return x.to_local(), sigma, (shard.groups, x.shape[0]), lambda out: shard.rewrap(out, x)


def dit_apply(model: DiT, x: torch.Tensor, sigma: torch.Tensor, *,
              return_aux: bool = False):
    """Predict epsilon for latent ``x`` (B,C,H,W) at noise level ``sigma``
    (B,); ``return_aux=True`` also returns the mean MoE load-balance loss.

    A DTensor ``x`` split on its batch (dp) runs on this rank's rows and
    gives a DTensor laid out alike, its aux that of the whole batch (the
    router's means summed over dp). A module from :func:`shard_dit_params`
    runs its tp and ep collectives inside its blocks."""
    xl, sl, dp, wrap = _local_rows(x, sigma)
    if not return_aux:
        return wrap(model(xl, sl))
    eps, aux = model(xl, sl, return_aux=True, dp=dp)
    return wrap(eps), aux


# ---------------------------------------------------------------------------
# Parallel layouts: tensor (tp), expert (ep) and pipeline (pp) parallelism
# ---------------------------------------------------------------------------


def pp_stage_params(model: DiT, n_stages: int, stage: int) -> DiT:
    """A DiT that holds stage ``stage`` of ``n_stages``: its contiguous
    blocks ``[stage·k, (stage+1)·k)``, k = depth / n_stages (the JAX package
    reshapes its stacked blocks to ``(stages, k, ...)`` and shards the stage
    axis over ``pp``). The embedding and head are kept whole; parameters are
    shared with ``model``. A depth the stage count does not divide raises."""
    depth = len(model.blocks)
    if model.pp_stage is not None:
        raise ValueError(f"the DiT is already stage {model.pp_stage[0]} of {model.pp_stage[1]}")
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} of {n_stages}")
    k = depth // n_stages
    staged = copy.copy(model)
    staged._modules = dict(model._modules)
    staged.blocks = nn.ModuleList(list(model.blocks)[stage * k:(stage + 1) * k])
    staged.pp_stage = (stage, n_stages)
    return staged


def _body_split(leaf: str, ndim: int, tp, ep) -> dict:
    """{mesh axis: dimension} of one block's parameter (port layout: a dense
    weight is (dout, din), an expert weight (E, din, dout)); the JAX
    package's dit_param_shardings, transposed where the port transposes."""
    layer, kind = leaf.rsplit(".", 1)
    expert = layer in ("mlp_in", "mlp_out") and ndim == (3 if kind == "weight" else 2)
    if expert:
        if kind == "bias":
            return {ep: 0}
        return {ep: 0, tp: 2} if layer == "mlp_in" else {ep: 0, tp: 1}
    if kind == "bias" or ndim != 2:
        return {}
    if layer in ("qkv", "mlp_in"):
        return {tp: 0}  # column-parallel: output features
    if layer in ("attn_out", "mlp_out"):
        return {tp: 1}  # row-parallel: input features
    return {}


def dit_param_shardings(model: DiT, mesh, *, tp: str | None = "tp", pp: str | None = None,
                        ep: str | None = "ep") -> dict:
    """Each parameter's DTensor placements (one per mesh axis) on ``mesh``,
    as the JAX package's ``dit_param_shardings`` lays its tree out:
    Megatron tensor parallelism on ``tp`` (``qkv``/``mlp_in`` split their
    output features, ``attn_out``/``mlp_out`` their input features; biases,
    adaLN, the router, the embedding and the head whole), expert weights'
    leading E axis on ``ep``, and with ``pp`` the block stack on ``pp``.

    Block parameters are keyed ``blocks.*.<name>`` and describe the stack of
    that parameter over the blocks, ``torch.stack([blocks.i.<name> ...])``:
    its dimension 0 is the block axis (the JAX tree's depth axis). Axes the
    mesh lacks are dropped, as the JAX package drops them."""
    names = tuple(mesh.mesh_dim_names)
    tp = tp if tp in names else None
    pp = pp if pp and pp in names else None
    ep = ep if ep and ep in names else None
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            split = {a: d + 1 for a, d in _body_split(".".join(parts[2:]), p.ndim, tp,
                                                      ep).items()}
            split[pp] = 0
            name = ".".join(["blocks", "*", *parts[2:]])
        else:
            split = {}
        plc = tuple(Shard(split[a]) if split.get(a) is not None else Replicate()
                    for a in names)
        if out.setdefault(name, plc) != plc:
            raise ValueError(f"dit_param_shardings: blocks disagree on {name}")
    return out


def shard_dit_params(model: DiT, mesh, shardings: dict) -> DiT:
    """This rank's part of ``model`` under ``shardings``
    (:func:`dit_param_shardings`): the stage's blocks where the block axis
    is split (:func:`pp_stage_params`), and of every parameter the block its
    mesh coordinates select (the JAX package's ``device_put`` of the tree).
    The blocks remember their tp and ep axes, so :func:`dit_apply` and
    :func:`dit_pp_apply` run their collectives. Returns a new module."""
    names = tuple(mesh.mesh_dim_names)

    def size(axis):
        return mesh.size(names.index(axis))

    stage_axes = {names[i] for k, plc in shardings.items() if k.startswith("blocks.*.")
                  for i, pl in enumerate(plc) if pl == Shard(0)}
    if len(stage_axes) > 1:
        raise ValueError(f"shard_dit_params: the block axis is split on {sorted(stage_axes)}")
    if stage_axes:
        (ax,) = stage_axes
        model = pp_stage_params(model, size(ax), mesh.get_local_rank(ax))
    local = copy.deepcopy(model)
    for name, p in list(local.named_parameters()):
        parts = name.split(".")
        block = parts[0] == "blocks"
        key = ".".join(["blocks", "*", *parts[2:]]) if block else name
        if key not in shardings:
            raise ValueError(f"shard_dit_params: no placements for {key}")
        t = p.detach()
        for i, pl in enumerate(shardings[key]):
            if not isinstance(pl, Shard) or (block and pl.dim == 0):
                continue
            d = pl.dim - 1 if block else pl.dim
            axis = names[i]
            if t.shape[d] % size(axis):
                raise ValueError(f"shard_dit_params: {name} {tuple(t.shape)} dimension {d} "
                                 f"over {size(axis)} '{axis}' ranks")
            t = t.chunk(size(axis), dim=d)[mesh.get_local_rank(axis)]
            if block:
                blk = local.blocks[int(parts[1])]
                layer = parts[2]
                if layer == "qkv" and parts[3] == "weight":
                    if local.cfg.num_heads % size(axis):
                        raise ValueError(f"num_heads {local.cfg.num_heads} not divisible by "
                                         f"tp size {size(axis)} (the qkv shard must hold "
                                         "whole heads)")
                    blk.tp = (mesh, axis)
                elif layer in ("mlp_in", "mlp_out") and local.cfg.num_experts:
                    if d != 0:
                        raise NotImplementedError("shard_dit_params: expert weights split "
                                                  "on tp; experts take ep only")
                    blk.ep = (mesh, axis)
        owner = local.get_submodule(".".join(parts[:-1]))
        setattr(owner, parts[-1], nn.Parameter(t.contiguous(), requires_grad=p.requires_grad))
    return local


def _block_axes(model: DiT) -> set:
    return {ax[1] for blk in model.blocks for ax in (blk.tp, blk.ep) if ax is not None}


def dit_pp_apply(model: DiT, x: torch.Tensor, sigma: torch.Tensor, mesh, *,
                 microbatches: int, pp: str = "pp", dp: str | None = "dp",
                 tp: str | None = None, return_aux: bool = False):
    """Pipeline-parallel forward (the JAX package's GPipe ``dit_pp_apply``):
    ``model`` holds this rank's stage (:func:`shard_dit_params` with a pp
    block axis, or :func:`pp_stage_params`) of a mesh whose ``pp`` axis has
    as many ranks as there are stages.

    ``microbatches + stages − 1`` ticks: stage 0 takes microbatch ``t``, a
    stage's conditioning rows lag the input by its depth, each stage hands
    its result to the next by ``ppermute``, the last banks finished
    microbatches, and a masked sum over pp gives every stage the output.
    A tick without a real microbatch computes nothing and hands on zeros.
    The aux (MoE) counts real microbatches only: the stages' sums over pp
    divided by stages × microbatches, then the mean over ``dp``.

    Composes with dp (a DTensor ``x`` split on its batch, or this rank's
    rows) and with tp inside a stage (dense MLP only; the blocks split on
    ``tp``). Raises where the JAX package raises: a stage count other than
    the mesh's, tp with MoE blocks, heads that tp does not divide, a local
    batch the microbatches do not divide, blocks split on another axis."""
    names = tuple(mesh.mesh_dim_names)
    s = mesh.size(names.index(pp))
    dp_ok = dp if dp and dp in names else None
    tp_ok = tp if tp and tp in names and mesh.size(names.index(tp)) > 1 else None
    cfg = model.cfg
    staged = model.pp_stage[1] if model.pp_stage is not None else len(model.blocks)
    if model.pp_stage is None or staged != s:
        raise ValueError(
            f"the DiT's stage axis is {staged}, mesh '{pp}' has {s} ranks — run "
            f"pp_stage_params(model, {s}, stage) first (a mismatched staging would "
            "silently drop blocks)")
    stage = mesh.get_local_rank(pp)
    if model.pp_stage[0] != stage:
        raise ValueError(f"the DiT holds stage {model.pp_stage[0]}, this rank is stage "
                         f"{stage} of '{pp}'")
    if tp_ok and cfg.num_experts:
        raise NotImplementedError(
            "dit_pp_apply tp composes with dense-MLP blocks only; MoE expert weights use "
            "the ep layout (plain dit_apply)")
    if tp_ok and cfg.num_heads % mesh.size(names.index(tp_ok)):
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp size "
                         f"{mesh.size(names.index(tp_ok))} (the qkv shard must hold whole heads)")
    extra = _block_axes(model) - {pp} - ({tp_ok} if tp_ok else set())
    if extra:
        raise NotImplementedError(
            "dit_pp_apply composes with dp" + ("×tp" if tp_ok else "") + " only; block "
            f"weights are also sharded on {sorted(extra)} — use plain dit_apply for ep "
            "layouts, or replicate those axes before staging")
    if tp_ok and any(blk.tp is None for blk in model.blocks):
        raise ValueError(f"tp={tp_ok!r}: the blocks are not split on it (shard_dit_params)")
    xl, sl, _, wrap = _local_rows(x, sigma)
    h, emb, hp, wp = model.embed(xl, sl)
    b = h.shape[0]
    if b % microbatches:
        n_dp = mesh.size(names.index(dp_ok)) if dp_ok else 1
        raise ValueError(
            f"per-shard batch {b} (global {b * n_dp}"
            + (f" over {n_dp} '{dp_ok}' shards" if dp_ok else "")
            + f") not divisible into {microbatches} microbatches")
    # the stages' blocks use the (whole) embedding and conditioning alike:
    # their gradients are summed over pp; the head's share is every stage's
    # own (it runs on the summed output everywhere)
    hb, eb = copy_to(h, mesh, pp), copy_to(emb, mesh, pp)
    # a stage with nothing to send on a tick sends zeros that carry a
    # gradient, so that every stage records every tick's handoff
    anchor = torch.zeros((), dtype=h.dtype, device=h.device, requires_grad=True)
    mb = b // microbatches
    h_mb = hb.reshape(microbatches, mb, *h.shape[1:])
    e_mb = eb.reshape(microbatches, mb, emb.shape[-1])
    out = torch.zeros_like(h_mb)
    buf = torch.zeros_like(h_mb[0])
    bufs = []
    aux_acc = torch.zeros((), dtype=torch.float32, device=h.device)
    fwd = [(i, i + 1) for i in range(s - 1)]
    for t in range(microbatches + s - 1):
        m = t - stage  # the microbatch this stage holds at tick t
        if 0 <= m < microbatches:
            res, aux = model.run_blocks(h_mb[t] if stage == 0 else buf, e_mb[m])
            if aux is not None:
                aux_acc = aux_acc + aux
            if stage == s - 1:
                out[m] = res
        else:
            res = torch.zeros_like(buf) + anchor
        buf = ppermute_grad(res, mesh, pp, fwd)
        bufs.append(buf)
    out = reduce_from(out if stage == s - 1 else torch.zeros_like(out), mesh, pp)
    eps = model.head(out.reshape(b, *h.shape[1:]), emb, hp, wp, xl.dtype)
    # the backward of every handoff and of the embedding's sum over pp must
    # run on every stage, also where this stage does not use them
    eps = join(eps, hb, *bufs)
    eps = wrap(eps)
    if not return_aux:
        return eps
    aux = reduce_from(aux_acc, mesh, pp) / (s * microbatches)
    if dp_ok:  # the mean over dp; a rank's gradient is its own share
        aux = reduce_from(aux, mesh, dp_ok) / mesh.size(names.index(dp_ok))
    return eps, aux


def make_dit_denoiser(model: DiT, *, prediction="eps", params_kwarg: str = "params",
                      timestep_fn: Callable | None = None, pp_mesh=None,
                      microbatches: int = 1, pp: str = "pp", dp: str | None = "dp",
                      tp: str | None = None) -> Callable:
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
    ``torch.func.functional_call``. Runs without autograd.

    ``pp_mesh`` switches the forward to the pipeline (:func:`dit_pp_apply`
    with ``microbatches``, ``pp``, ``dp`` and ``tp``): ``model`` is then this
    rank's stage. The sampler hands the denoiser this rank's rows, so each
    model call is one pipelined forward of the local batch."""
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
        if pp_mesh is not None:
            if p is not None:
                raise NotImplementedError(f"{params_kwarg}= with pp_mesh: the pipeline runs "
                                          "the stage's own weights")
            out = dit_pp_apply(model, xin, cond, pp_mesh, microbatches=microbatches, pp=pp,
                               dp=dp, tp=tp)
        elif p is None:
            out = model(xin, cond)
        else:
            out = torch.func.functional_call(model, p, (xin, cond))
        return pred.calculate_denoised(s4, out, x)

    return denoiser
