"""Run one function in every rank of a ``torch.distributed`` world.

The JAX package needs no launcher: one process drives every device of its
mesh. A PyTorch world is one process a rank, so the port's tests and its
smoke run start their worlds here. The ranks meet through a ``FileStore`` in
a temporary directory: no TCP port is opened, so worlds started side by side
(test workers) cannot clash.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a rank that has neither answered nor died after this long counts as hung
_RESULT_TIMEOUT_S = 1800.0


def _rank_main(rank: int, nprocs: int, store_path: str, backend: str, device_type: str,
               call_path: str, results) -> None:
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=dist.FileStore(store_path, nprocs),
                                rank=rank, world_size=nprocs)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, nprocs: int, *, backend: str, device_type: str,
              args: Sequence = ()) -> list[Any]:
    """Start ``nprocs`` processes (spawned), make them one world of
    ``backend`` ("gloo" or "nccl"), call ``fn(*args)`` in each and return the
    results by rank. ``fn`` and its results must pickle (``fn`` a module-level
    function). Each rank runs torch on one thread; with ``device_type="cuda"``
    rank r uses card ``r % device_count`` (two ranks may share a card under
    gloo; NCCL takes one rank a card). A rank that raises makes this raise,
    naming the rank and carrying its traceback."""
    if nprocs < 1:
        raise ValueError(f"run_world: nprocs must be at least 1, got {nprocs}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"run_world: device_type must be 'cpu' or 'cuda', got {device_type!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        # the call goes through a file: a pipe holds 64 KiB, and a start that
        # waits for its child to read a larger one would start the ranks in turn
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, store, backend, device_type, call, results),
                             daemon=True)
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        failed: list[str] = []
        deadline = time.monotonic() + _RESULT_TIMEOUT_S
        try:
            # drain the queue before joining: a child blocks on a full pipe
            while len(got) + len(failed) < nprocs:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_world: ranks {sorted(set(range(nprocs)) - set(got))} "
                                       f"gave no result in {_RESULT_TIMEOUT_S:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=5.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(f"run_world: rank(s) {dead} exited with "
                                           f"{[procs[r].exitcode for r in dead]} and no result")
                    if all(not p.is_alive() for p in procs):
                        raise RuntimeError("run_world: every rank exited, results missing")
                    continue
                if ok:
                    got[rank] = out
                else:
                    failed.append(f"rank {rank} of {nprocs} raised:\n{out}")
                    # the others may wait on the failed rank in a collective
                    break
        finally:
            for p in procs:
                p.join(timeout=60.0 if not failed else 5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
        if failed:
            raise RuntimeError("\n".join(failed))
        return [got[r] for r in range(nprocs)]
