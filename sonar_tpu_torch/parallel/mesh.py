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
mesh axis's process group (a maximum or minimum over ranks is an
``all_reduce`` of a world-sized stack in which each rank fills its entry),
and a group of one rank makes no call at all. Those two are the collectives that the gloo
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
import copy
import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn
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
    # the dimension each of ``groups`` splits
    dims: tuple = dataclasses.field(default=(), compare=False)

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
        groups, dims = [], []
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
            dims.append(p.dim)
        return cls(shape, tuple(offset), tuple(local), tuple(groups), tuple(dims))

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

    def plane_index(self, device) -> torch.Tensor:
        """The global plane of each local plane (row-major), as int64."""
        first, run, stride = self.plane_runs()
        i = torch.arange(math.prod(self.local_shape[:-2]), dtype=torch.int64, device=device)
        return first + (i // run) * stride + i % run

    def groups_over(self, dims) -> tuple:
        """The groups that split one of ``dims`` (a reduction over ``dims``
        sums over these ranks; the others hold other rows)."""
        nd = len(self.global_shape)
        want = {d % nd for d in dims}
        return tuple(g for g, d in zip(self.groups, self.dims) if d in want)

    def resized(self, local_shape) -> "LatentShard":
        """The same block of a field whose dimensions that are not split
        have other sizes (a channel of the latent, another H × W)."""
        local_shape = tuple(local_shape)
        if len(local_shape) != len(self.local_shape) or any(
                local_shape[d] != self.local_shape[d] for d in self.dims):
            raise NotImplementedError(f"LatentShard: {local_shape} changes a split "
                                      f"dimension of {self.local_shape}")
        glob = tuple(self.global_shape[d] if d in self.dims else n
                     for d, n in enumerate(local_shape))
        off = tuple(self.offset[d] if d in self.dims else 0 for d in range(len(glob)))
        return LatentShard(glob, off, local_shape, self.groups, self.dims)

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


def _groups(groups) -> tuple:
    """The groups of ``groups`` (one group or a sequence) that hold more than
    one rank: a sum over a 1-rank group is the value itself, and makes no
    call."""
    gs = groups if isinstance(groups, (tuple, list)) else (groups,)
    return tuple(g for g in gs if dist.get_world_size(g) > 1)


def all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``t`` over the ranks of each process group in ``groups``
    (one group or a sequence, reduced in turn); ``t`` is left as it is. Where
    every group has one rank the result is a copy of ``t``, and no
    collective runs."""
    out = t.contiguous().clone()
    with _collective(out):
        for g in _groups(groups):
            dist.all_reduce(out, group=g)
    return out


def _all_extreme(t: torch.Tensor, groups, largest: bool) -> torch.Tensor:
    for g in _groups(groups):
        # a world-sized stack in which each rank fills its own entry: the sum
        # over the ranks holds every rank's value, and the extreme is exact
        buf = torch.zeros((dist.get_world_size(g),) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        buf[dist.get_rank(g)] = t
        buf = all_reduce(buf, g)
        t = buf.amax(0) if largest else buf.amin(0)
    return t.clone()


def all_max(t: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks of each group in
    ``groups`` (in turn), from ``all_reduce`` alone."""
    return _all_extreme(t, groups, True)


def all_min(t: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise minimum of ``t`` over the ranks of each group in
    ``groups`` (in turn), from ``all_reduce`` alone."""
    return _all_extreme(t, groups, False)


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
    return _permute(t, group, dist.get_process_group_ranks(group), mesh.get_local_rank(axis),
                    perm)


def _permute(t, group, ranks, me, perm):
    """:func:`ppermute` on ``group`` (global ``ranks``, this rank's axis
    position ``me``)."""
    out = torch.zeros_like(t)
    src_t = t.contiguous()
    with _collective(src_t):
        for src, dst in perm:
            buf = src_t.clone() if me == src else torch.empty_like(src_t)
            dist.broadcast(buf, src=ranks[src], group=group)
            if me == dst:
                out = buf
    return out


# -- the UNet's parameter layouts: tensor parallelism on tp, FSDP on dp --------------------

# the row-parallel layers (attention's output projection, the time MLP's
# second layer): their input features are split; every other weight splits
# its output features (column-parallel)
_ROW_PARALLEL = ("proj", "fc2")
# the port's dimension of each dimension of the JAX package's weight: a dense
# (din, dout) is the port's (dout, din), a conv HWIO the port's OIHW
_JAX_DIMS = {2: (1, 0), 4: (2, 3, 1, 0)}


def unet_param_shardings(model, mesh: DeviceMesh, *, fsdp: bool = False,
                         fsdp_axis: str = "dp") -> dict:
    """Each UNet parameter's DTensor placements (one per mesh axis) on
    ``mesh``, keyed by its ``named_parameters`` name: the JAX package's
    ``unet_param_shardings`` in the port's weight layouts.

    Tensor parallelism on ``tp``: conv kernels and the dense layers split
    their output features (column-parallel), ``proj`` and ``fc2`` their input
    features (row-parallel); biases and norm leaves stay whole. ``fsdp=True``
    also splits each weight's largest other dimension that the ``fsdp_axis``
    size divides over that axis (ties go to the first in the JAX weight's
    dimension order, as ``max`` picks there; 1-D leaves stay whole), when the
    axis has more than one rank. The JAX spec always names ``tp``: a mesh
    without a ``tp`` axis raises, as does ``fsdp=True`` on a mesh without
    ``fsdp_axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if fsdp and fsdp_axis not in names:
        # a silent no-op here means the expected ~dp× memory reduction
        # quietly doesn't happen
        raise ValueError(f"fsdp=True but mesh has no {fsdp_axis!r} axis (axes: {names}) "
                         "— pass fsdp_axis=")
    if "tp" not in names:
        raise ValueError(f"unet_param_shardings: the UNet's layout splits weights on 'tp', "
                         f"and the mesh's axes are {names}")
    dp_size = mesh.size(names.index(fsdp_axis)) if fsdp else 0
    out = {}
    for name, p in model.named_parameters():
        split = {}
        if p.ndim in _JAX_DIMS:
            perm = _JAX_DIMS[p.ndim]
            if p.ndim == 2:
                jax_tp = 0 if any(n in _ROW_PARALLEL for n in name.split(".")) else 1
            else:
                jax_tp = 3
            split["tp"] = perm[jax_tp]
            if dp_size > 1:
                jshape = [p.shape[perm[j]] for j in range(p.ndim)]
                cands = [j for j in range(p.ndim) if j != jax_tp
                         and jshape[j] % dp_size == 0 and jshape[j] >= dp_size]
                if cands:
                    split[fsdp_axis] = perm[max(cands, key=lambda j: jshape[j])]
        out[name] = tuple(Shard(split[a]) if a in split else Replicate() for a in names)
    return out


def shard_unet_params(model, mesh: DeviceMesh, *, fsdp: bool = False, fsdp_axis: str = "dp"):
    """This rank's part of the UNet ``model`` under
    :func:`unet_param_shardings`: a new module that holds, of every
    parameter, the block its mesh coordinates select (the JAX package's
    ``device_put`` of the tree), its layers set to run their collectives
    (:class:`~sonar_tpu_torch.models.unet.LayerLayout`): a column-parallel
    layer gathers its output features over tp, a row-parallel one sums its
    partial products, an FSDP weight is gathered over ``fsdp_axis`` before
    each use and its gradient reduce-scattered. Group norms, attention and
    the skips run on whole activations. ``fsdp_params`` on the result names
    the parameters split on ``fsdp_axis`` (``fsdp_group`` its process group).
    A dimension the axis size does not divide raises, naming the layout."""
    from ..models.unet import Conv, Dense, LayerLayout

    shardings = unet_param_shardings(model, mesh, fsdp=fsdp, fsdp_axis=fsdp_axis)
    names = tuple(mesh.mesh_dim_names)
    layout = "tp" + (f" + FSDP on {fsdp_axis!r}" if fsdp else "")
    local = copy.deepcopy(model)
    split_on = {}
    for name, p in list(local.named_parameters()):
        t = p.detach()
        for i, pl in enumerate(shardings[name]):
            if not isinstance(pl, Shard):
                continue
            size, axis = mesh.size(i), names[i]
            if t.shape[pl.dim] % size:
                raise ValueError(f"shard_unet_params ({layout}): {name} {tuple(p.shape)} "
                                 f"dimension {pl.dim} does not split over {size} {axis!r} ranks")
            t = t.chunk(size, dim=pl.dim)[mesh.get_local_rank(axis)]
            split_on[(name, axis)] = pl.dim
        owner, leaf = name.rsplit(".", 1)
        setattr(local.get_submodule(owner), leaf,
                nn.Parameter(t.contiguous(), requires_grad=p.requires_grad))
    for mod_name, mod in local.named_modules():
        if isinstance(mod, (Conv, Dense)):
            w = f"{mod_name}.weight"
            tp_dim = split_on.get((w, "tp"))
            mod.layout = LayerLayout(
                mesh, tp="tp", kind="column" if tp_dim == 0 else "row",
                fsdp=fsdp_axis if (w, fsdp_axis) in split_on else None,
                fsdp_dim=split_on.get((w, fsdp_axis)))
    local.fsdp_params = frozenset(n for n, a in split_on if a == fsdp_axis and fsdp)
    local.fsdp_group = mesh.get_group(fsdp_axis) if local.fsdp_params else None
    return local


def shard_target(tensors: dict, mesh: DeviceMesh, shardings: dict) -> dict:
    """``tensors`` (this rank's blocks, keyed as ``shardings``) as DTensors
    with their placements: a restore target that lands each saved tensor's
    block on this rank (:func:`~sonar_tpu_torch.models.restore_checkpoint`).
    Nothing is sent."""
    return {k: DTensor.from_local(v, mesh, shardings[k], run_check=False)
            for k, v in tensors.items()}
