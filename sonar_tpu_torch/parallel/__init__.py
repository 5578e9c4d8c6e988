"""Mesh and sharding layer: dp-sharded sampling and the DiT's parallel
serving paths, one process a rank (port of ``sonar_tpu.parallel``; the
UNet's tensor- and FSDP-parallel parameter layouts, which only its training
steps use, are not here yet)."""

from .launch import run_world  # noqa: F401
from .mesh import (  # noqa: F401
    LatentShard,
    all_reduce,
    latent_spec,
    make_mesh,
    placements,
    pmean,
    ppermute,
    psum,
    shard_latent,
)
