"""Train-state checkpoints (port of ``sonar_tpu.models.checkpoint``): save
and restore params and optimizer state.

A checkpoint is a directory holding one ``state.pt``, written by
``torch.save`` and read by ``torch.load(weights_only=True)``: nested dicts,
lists and tuples of tensors and plain numbers, e.g.
``{"params": model.state_dict(), "opt_state": optimizer.state_dict(),
"step": 7}``. ``torch.save`` keeps the structure, so a restore hands back an
``opt_state`` that ``optimizer.load_state_dict`` accepts. The directory is
written beside its path and moved into place with ``os.replace``, so a
reader sees the whole checkpoint or none.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from collections.abc import Mapping
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from ..parallel.mesh import _chunk
from ..utils.misc import default_device

_STATE_FILE = "state.pt"


def save_checkpoint(path: str | os.PathLike, state: Any, *, force: bool = False) -> None:
    """Atomically write ``state`` to the directory ``path``. An existing
    ``path`` raises ``FileExistsError`` unless ``force``, which replaces it."""
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists; pass force=True to replace it")
    parent, name = os.path.split(path)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=parent)
    try:
        torch.save(state, os.path.join(tmp, _STATE_FILE))
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{name}.old-", dir=parent)
            os.replace(path, os.path.join(old, name))
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)


def _onto(target: Any, loaded: Any, partial: bool, where: str) -> Any:
    """``loaded`` shaped by ``target``: tensors converted to the target
    tensor's device and dtype; with ``partial``, only the keys ``target``
    names."""
    if isinstance(target, Mapping):
        if not isinstance(loaded, Mapping):
            raise ValueError(f"checkpoint{where}: a dict in the target, {type(loaded).__name__} "
                             "in the checkpoint")
        missing = set(target) - set(loaded)
        extra = set() if partial else set(loaded) - set(target)
        if missing or extra:
            raise KeyError(f"checkpoint{where}: target keys differ (missing {sorted(map(str, missing))}, "
                           f"not in the target {sorted(map(str, extra))}); partial=True "
                           "restores a subtree")
        return {k: _onto(v, loaded[k], partial, f"{where}[{k!r}]") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(target):
            raise ValueError(f"checkpoint{where}: the target's sequence differs")
        return type(target)(_onto(t, v, partial, f"{where}[{i}]")
                            for i, (t, v) in enumerate(zip(target, loaded)))
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != target.shape:
            raise ValueError(f"checkpoint{where}: shape {getattr(loaded, 'shape', None)}, "
                             f"the target's {tuple(target.shape)}")
        if isinstance(target, DTensor):  # this rank's block, read from the mapped file
            local = target.to_local()
            block = _chunk(loaded, target.device_mesh, target.placements)
            return DTensor.from_local(block.to(device=local.device, dtype=local.dtype, copy=True),
                                      target.device_mesh, target.placements, run_check=False,
                                      shape=target.shape, stride=target.stride())
        return loaded.to(device=target.device, dtype=target.dtype)
    return loaded


def _has_dtensor(tree: Any) -> bool:
    if isinstance(tree, Mapping):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return isinstance(tree, DTensor)


def _is_optimizer_state(tree: Any) -> bool:
    return (isinstance(tree, Mapping) and set(tree) == {"state", "param_groups"}
            and isinstance(tree["state"], Mapping))


def _to_device(tree: Any, device) -> Any:
    """``tree`` with its tensors on ``device``, except the 0-dim ``step``
    counts of an optimizer's state dict: torch's optimizers keep those where
    ``load_state_dict`` finds them, and on the host a step reads none back
    (a fused or capturable optimizer moves them to its parameters itself)."""
    if _is_optimizer_state(tree):
        state = {j: {k: v if k == "step" and isinstance(v, torch.Tensor) and v.dim() == 0
                     else _to_device(v, device) for k, v in s.items()}
                 for j, s in tree["state"].items()}
        return {"state": state, "param_groups": tree["param_groups"]}
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def restore_checkpoint(path: str | os.PathLike, *, target: Any = None,
                       partial: bool = False) -> Any:
    """Load a checkpoint written by :func:`save_checkpoint`.

    Without ``target`` the saved structure comes back whole, its tensors on
    :func:`~sonar_tpu_torch.utils.misc.default_device` (the card unless the
    caller's code runs elsewhere), but for an optimizer state's ``step``
    counts, which stay on the host so that a resumed step reads nothing back
    from the card. ``target`` is a tree of the same structure
    (e.g. a fresh state's ``{"params": model.state_dict(), ...}``): each
    tensor comes back on the target tensor's device and in its dtype, and a
    structure or shape that differs raises. ``partial=True`` lets ``target``
    name a subtree (e.g. ``{"params": ...}`` out of a full train state);
    only the named entries come back.

    A sharded target: a ``DTensor`` leaf (a rank's block with its mesh and
    placements, :func:`~sonar_tpu_torch.parallel.shard_target`; replicated,
    or the FSDP layout of ``unet_param_shardings(..., fsdp=True)``) comes
    back as a DTensor laid out alike, its local tensor this rank's block of
    the saved tensor, bit for bit. The file is then read memory-mapped, so a
    rank reads only its blocks' pages and nothing is gathered. For an
    optimizer's state the target may name the moments alone: a leaf whose
    target is not a tensor (e.g. None for Adam's ``step``) comes back as
    saved, on the host."""
    file = os.path.join(os.path.abspath(os.fspath(path)), _STATE_FILE)
    loaded = torch.load(file, map_location="cpu", weights_only=True,
                        mmap=_has_dtensor(target))
    if target is None:
        return _to_device(loaded, default_device())
    return _onto(target, loaded, partial, "")
