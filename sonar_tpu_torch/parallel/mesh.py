"""Mesh and sharding layer (port of ``sonar_tpu.parallel.mesh``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. The port runs one process a rank, each
holding its own shard, and calls the collectives itself:

- a mesh is a ``torch.distributed`` ``DeviceMesh`` over the world's ranks,
  axes ``("dp", "tp")`` by default (``"sp"`` for the frames of a 5-D video
  latent, ``"pp"``, ``"ep"`` for the DiT);
- a latent is a ``DTensor``, batch split on ``dp`` (and frames on ``sp``);
  the samplers step its local shard and hand back a ``DTensor`` with the
  same placements;
- the noise of a shard is the rank's slice of the unsharded draw
  (:class:`LatentShard` says where the slice lies), and the global noise
  statistics are the only collectives of a sampling step besides the
  denoiser's own.

Every collective here is built from ``all_reduce`` and ``broadcast`` over a
mesh axis's process group. Those two are the collectives that the gloo
backend takes on CUDA tensors, and NCCL takes one rank a card: so the same
code runs as a 1-rank NCCL world on one card, as several gloo ranks sharing
one card, and as gloo worlds on the CPU in the tests. ``ppermute`` (the
pipeline's neighbour handoff) is one broadcast over the axis a pair.

A collective on the card may synchronise with the host under gloo; the
collectives lift ``torch.cuda.set_sync_debug_mode`` for their own span, so
that a caller can check the rest of a sharded step for host reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def make_mesh(n_devices: int | None = None, *, axis_names: Sequence[str] = ("dp", "tp"),
              mesh_shape: Sequence[int] | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over ranks ``0 .. n_devices-1`` of the initialised
    world (all of it by default). Every rank of the world calls this.

    Without ``mesh_shape`` the ranks factor as the JAX package factors its
    devices: one axis takes them all; otherwise tp is the largest power of
    two ≤ 4 that divides the count, the first axis the rest, further axes 1."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed world (init_process_group "
                           "first, or start one with parallel.run_world)")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    axis_names = tuple(axis_names)
    if mesh_shape is None:
        if len(axis_names) == 1:
            mesh_shape = (n,)
        else:
            tp = 1
            while tp < 4 and n % (tp * 2) == 0:
                tp *= 2
            mesh_shape = (n // tp, tp) + (1,) * (len(axis_names) - 2)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if math.prod(mesh_shape) != n or len(mesh_shape) != len(axis_names):
        raise ValueError(f"make_mesh: shape {mesh_shape} for axes {axis_names} does not "
                         f"hold {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(mesh_shape),
                      mesh_dim_names=axis_names)


def latent_spec(ndim: int, *, dp: str = "dp", sp: str | None = None) -> tuple:
    """The mesh axis each dimension of a latent is split on, None where it is
    whole (the JAX ``PartitionSpec``'s entries): batch on ``dp``; for a 5-D
    (B, C, F, H, W) latent with ``sp``, frames on ``sp`` too."""
    if ndim == 5 and sp is not None:
        return (dp, None, sp, None, None)
    return (dp,) + (None,) * (ndim - 1)


def placements(mesh: DeviceMesh, spec: Sequence) -> tuple:
    """DTensor placements (one per mesh axis) of a tensor spec as
    :func:`latent_spec` gives it: ``Shard(d)`` on the axis that dimension
    ``d`` names, ``Replicate()`` on the others. Axes the mesh lacks are
    dropped, as the JAX package drops them from its shardings."""
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        if axis is None or axis not in names:
            continue
        i = names.index(axis)
        if out[i] != Replicate():
            raise ValueError(f"placements: axis {axis!r} splits two dimensions of {spec}")
        out[i] = Shard(d)
    return tuple(out)


def _chunk(x: torch.Tensor, mesh: DeviceMesh, plc: Sequence) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``plc`` (even splits)."""
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            size, me = mesh.size(i), mesh.get_local_rank(i)
            if x.shape[p.dim] % size:
                raise ValueError(f"dimension {p.dim} of {tuple(x.shape)} does not split "
                                 f"evenly over {size} ranks")
            x = x.chunk(size, dim=p.dim)[me]
    return x.contiguous()


def shard_latent(x: torch.Tensor, mesh: DeviceMesh, *, sp: str | None = None) -> DTensor:
    """``x`` as a DTensor laid out by :func:`latent_spec`. ``x`` is the whole
    latent, the same on every rank (a seeded draw): each rank keeps its block
    and nothing is sent."""
    plc = placements(mesh, latent_spec(x.ndim, sp=sp))
    return DTensor.from_local(_chunk(x, mesh, plc), mesh, plc, run_check=False,
                              shape=x.shape, stride=x.stride())


# -- where a rank's shard lies ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatentShard:
    """This rank's block of a latent of ``global_shape``: it starts at
    ``offset`` and has ``local_shape``. ``groups`` are the process groups of
    the mesh axes the latent is split on: a sum over each in turn is a sum
    over the whole latent. H and W (the last two dimensions) are never split."""

    global_shape: tuple[int, ...]
    offset: tuple[int, ...]
    local_shape: tuple[int, ...]
    groups: tuple = dataclasses.field(default=(), compare=False)

    def __post_init__(self):
        g, o, n = self.global_shape, self.offset, self.local_shape
        if not len(g) == len(o) == len(n) or len(g) < 3:
            raise ValueError(f"LatentShard: shapes {g}, {o}, {n}")
        if tuple(g[-2:]) != tuple(n[-2:]) or any(o[-2:]):
            raise NotImplementedError("LatentShard: H and W are never split")
        if any(a + b > c for a, b, c in zip(o, n, g)):
            raise ValueError(f"LatentShard: block {o} + {n} outside {g}")
        self.plane_runs()  # the block must be runs of planes at a fixed stride

    @classmethod
    def of(cls, x: DTensor) -> "LatentShard":
        """The shard a DTensor latent holds on this rank."""
        mesh, shape = x.device_mesh, tuple(x.shape)
        offset, local = [0] * len(shape), list(shape)
        groups = []
        for i, p in enumerate(x.placements):
            if isinstance(p, Replicate):
                continue
            if not isinstance(p, Shard) or local[p.dim] != shape[p.dim]:
                raise NotImplementedError(f"LatentShard: placements {x.placements}")
            size = mesh.size(i)
            if shape[p.dim] % size:
                raise ValueError(f"LatentShard: dimension {p.dim} of {shape} over {size}")
            local[p.dim] = shape[p.dim] // size
            offset[p.dim] = mesh.get_local_rank(i) * local[p.dim]
            groups.append(mesh.get_group(i))
        return cls(shape, tuple(offset), tuple(local), tuple(groups))

    def plane_runs(self) -> tuple[int, int, int]:
        """The block's planes (all dimensions but H and W, row-major) in the
        global latent's: local plane ``i`` is global plane
        ``first + (i // run) * stride + i % run``."""
        g, o, n = self.global_shape[:-2], self.offset[:-2], self.local_shape[:-2]
        inner = [math.prod(g[d + 1:]) for d in range(len(g))]
        first = sum(a * s for a, s in zip(o, inner))
        split = [d for d in range(len(g)) if n[d] != g[d]]
        if not split:
            total = math.prod(g)
            return first, total, total
        k = split[-1]
        # rows of the dimensions before k must follow one another at the stride
        for d in range(k):
            if n[d] > 1 and tuple(n[d + 1:k]) != tuple(g[d + 1:k]):
                raise NotImplementedError(
                    f"LatentShard: block {n} at {o} of {g} is not runs at one stride")
        return first, n[k] * inner[k], g[k] * inner[k]

    def runs(self, h: int, w: int) -> tuple[int, int, int]:
        """:meth:`plane_runs` in elements, for a field of ``h × w`` planes."""
        first, run, stride = self.plane_runs()
        return first * h * w, run * h * w, stride * h * w

    def rewrap(self, local: torch.Tensor, like: DTensor) -> DTensor:
        """``local`` (this rank's block) as a DTensor laid out as ``like``."""
        return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())


# -- collectives: all_reduce and broadcast only -------------------------------------


@contextlib.contextmanager
def _collective(t: torch.Tensor):
    """Lift the sync debug check for a collective's own span (gloo copies a
    CUDA tensor through the host)."""
    mode = torch.cuda.get_sync_debug_mode() if t.is_cuda else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``t`` over the ranks of each process group in ``groups``
    (one group or a sequence, reduced in turn); ``t`` is left as it is."""
    out = t.contiguous().clone()
    with _collective(out):
        for g in (groups if isinstance(groups, (tuple, list)) else (groups,)):
            dist.all_reduce(out, group=g)
    return out


def psum(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over one mesh axis."""
    return all_reduce(t, mesh.get_group(axis))


def pmean(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.pmean`` over one mesh axis."""
    return psum(t, mesh, axis) / mesh.size(mesh.mesh_dim_names.index(axis))


def ppermute(t: torch.Tensor, mesh: DeviceMesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute`` over one mesh axis: for each ``(src, dst)`` pair of
    axis positions, ``dst`` receives ``src``'s ``t``; a position no pair
    sends to gets zeros. One broadcast over the axis a pair, in the order
    given, which every rank of the axis must share."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.get_local_rank(axis)
    out = torch.zeros_like(t)
    src_t = t.contiguous()
    with _collective(src_t):
        for src, dst in perm:
            buf = src_t.clone() if me == src else torch.empty_like(src_t)
            dist.broadcast(buf, src=ranks[src], group=group)
            if me == dst:
                out = buf
    return out
