"""Mesh and sharding layer: dp-sharded sampling, the DiT's parallel serving
paths, and sharded training (the UNet's tensor- and FSDP-parallel parameter
layouts, collectives with gradients in ``grad``), one process a rank (port
of ``sonar_tpu.parallel``)."""

from .launch import run_world  # noqa: F401
from .mesh import (  # noqa: F401
    LatentShard,
    all_max,
    all_min,
    all_reduce,
    latent_spec,
    make_mesh,
    placements,
    pmean,
    ppermute,
    psum,
    shard_latent,
    shard_target,
    shard_unet_params,
    unet_param_shardings,
)
