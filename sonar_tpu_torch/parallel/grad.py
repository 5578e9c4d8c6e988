"""Collectives with gradients: what a sharded training step differentiates
through (the JAX package gets them from ``jax.grad`` over its SPMD program).

Each is a ``torch.autograd.Function`` on :func:`~.mesh.all_reduce` and
``broadcast`` (the collectives gloo takes on CUDA tensors), over one mesh
axis. Every rank computes the same loss, and each differentiates that one
loss with respect to what it holds:

- :func:`reduce_from` — ``psum`` forward, identity backward: the sum of the
  ranks' partial products (a row-parallel layer's output), used alike on
  every rank;
- :func:`copy_to` — identity forward, ``psum`` backward: a tensor whole on
  every rank that each rank uses differently (the input of a column-parallel
  layer, a replicated bias it slices);
- :func:`gather` — the ranks' blocks of one dimension concatenated (an
  ``all_reduce`` of the zero-padded block), backward the rank's slice of the
  gradient: the output of a column-parallel layer;
- :func:`fsdp_gather` — the same gather of a weight's FSDP blocks, backward a
  reduce-scatter (``all_reduce``, then the rank's slice): each rank's
  gradient block summed over the ranks' batches;
- :func:`ppermute_grad` — ``lax.ppermute``, backward the reverse
  permutation.

The backward of a collective is itself a collective, so every rank of the
axis must reach it, in the same order. PyTorch's autograd runs the nodes a
loss reaches in the reverse order of their creation; a rank that only sends
(the first pipeline stage) has nothing that reaches its sends, so
:func:`join` ties tensors a rank computed but does not use into its result
(their gradient is zero). The forward-only collectives of :mod:`.mesh` stay
what serving uses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import _permute, all_reduce


def _axis(mesh, axis: str):
    """(process group, this rank's position, the axis size)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def _zero_padded(t: torch.Tensor, dim: int, me: int, size: int) -> torch.Tensor:
    shape = list(t.shape)
    k = shape[dim]
    shape[dim] = k * size
    out = t.new_zeros(shape)
    out.narrow(dim, me * k, k).copy_(t)
    return out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, me, size, reduce_grad):
        ctx.args = (group, dim, me, t.shape[dim], reduce_grad)
        return all_reduce(_zero_padded(t, dim, me, size), group)

    @staticmethod
    def backward(ctx, g):
        group, dim, me, k, reduce_grad = ctx.args
        if reduce_grad:
            g = all_reduce(g, group)
        return g.narrow(dim, me * k, k).contiguous(), None, None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, ranks, me, perm):
        ctx.args = (group, ranks, me, tuple((d, s) for s, d in perm))
        return _permute(t, group, ranks, me, perm)

    @staticmethod
    def backward(ctx, g):
        group, ranks, me, back = ctx.args
        return _permute(g, group, ranks, me, back), None, None, None, None


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *unused):
        ctx.shapes = [(u.shape, u.dtype, u.device) for u in unused]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes))


def reduce_from(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` over ``axis``; the gradient passes through unchanged."""
    return _ReduceFrom.apply(t, mesh.get_group(axis))


def reduce_from_groups(t: torch.Tensor, groups) -> torch.Tensor:
    """:func:`reduce_from` over process groups (one or a sequence, in turn)."""
    return _ReduceFrom.apply(t, groups)


def copy_to(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` itself; its gradient is summed over ``axis``."""
    return _CopyTo.apply(t, mesh.get_group(axis))


def gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' equal blocks of dimension ``dim`` concatenated in axis
    order; the gradient of a block is its slice of the (equal) gradients."""
    group, me, size = _axis(mesh, axis)
    return _Gather.apply(t, group, dim % t.dim(), me, size, False)


def fsdp_gather(w: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """A weight whole along ``dim`` from the ranks' FSDP blocks; the gradient
    of a block is its slice of the ranks' gradients summed (reduce-scatter)."""
    group, me, size = _axis(mesh, axis)
    return _Gather.apply(w, group, dim % w.dim(), me, size, True)


def ppermute_grad(t: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """:func:`~.mesh.ppermute` (one broadcast a pair, zeros where no pair
    sends) whose gradient goes back along the reversed pairs."""
    group = mesh.get_group(axis)
    return _PPermute.apply(t, group, dist.get_process_group_ranks(group),
                           mesh.get_local_rank(axis), tuple(perm))


def join(out: torch.Tensor, *unused: torch.Tensor) -> torch.Tensor:
    """``out``, with ``unused`` tied in so that a backward from ``out``
    reaches them (with a zero gradient): every collective behind them then
    runs its backward on this rank too."""
    unused = tuple(u for u in unused if u.requires_grad)
    return _Join.apply(out, *unused) if unused else out
