"""Denoiser training step (port of ``sonar_tpu.models.train``): the
denoising score-matching loss for the UNet and the DiT, updated in place.

Sample a noise level per example, noise the clean latent, and regress the
network output onto its target: epsilon under EDM input scaling with
log-uniform sigmas (``objective="eps"``), or the rectified-flow velocity
(``objective="flow"``). A torch optimizer is its update rule and its state
at once, so the JAX pair (``optimizer``, ``opt_state``) is one object here:
:func:`init_train_state` builds it over the module's parameters and the step
takes it as ``opt_state``.

The step's draws (sigma's uniforms and eps) come from the port's one seeded
stream (:mod:`sonar_tpu_torch.kernels.hwrng`, kernel B3 on the card), on two
seeds derived from the step's integer seed; :func:`train_draws` holds both.
Nothing in a step reads back from the card: the loss is returned as a
float32 tensor on the batch's device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..cfg.model_sampling import time_snr_shift
from ..core.rng import derive_seed
from ..kernels.hwrng import philox_rand, philox_randn
from ..parallel.grad import reduce_from_groups
from ..parallel.mesh import LatentShard, all_reduce
from .dit import dit_pp_apply

# the products "dots" keeps: matmuls with no batch dimension (the dense
# layers), as jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps
# dot_generals without batch dims; batched products and convolutions are
# recomputed
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_apply(remat: bool | str, apply_fn: Callable) -> Callable:
    """Resolve the ``remat`` knob to a (possibly checkpointed) apply fn. Like
    ``jax.checkpoint(apply_fn)``, a checkpoint wraps the whole forward."""
    if remat is False:
        return apply_fn
    # the forward draws nothing, so the recompute needs no saved RNG state
    ckpt = functools.partial(checkpoint, apply_fn, use_reentrant=False, preserve_rng_state=False)
    if remat is True or remat == "full":
        # save nothing inside: recompute the whole forward during the backward
        return ckpt
    if remat == "dots":
        return functools.partial(
            ckpt, context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(
        f"unknown remat policy {remat!r}; valid: False, True, 'full', 'dots'")


def train_draws(seed: int, batch: torch.Tensor, shard=None):
    """The step's random draws: ``(u, eps)``, ``u`` (B,) uniform in [0, 1)
    for the noise level and ``eps`` standard normal like ``batch``, each on
    its own seed derived from ``seed``.

    ``shard`` (a :class:`~sonar_tpu_torch.parallel.LatentShard`, ``batch``
    its local block, split on the batch dimension): the rank's slice of the
    whole batch's draws, B3 at their global indices: ``u`` the rows
    ``(first, b, B)`` of the global (B,) draw, ``eps`` the block's elements."""
    kw = {}
    if shard is not None:
        first, b, big = shard.offset[0], shard.local_shape[0], shard.global_shape[0]
        if tuple(shard.local_shape[1:]) != tuple(shard.global_shape[1:]):
            raise NotImplementedError(f"train_draws: a batch split on more than its batch "
                                      f"dimension ({shard.local_shape} of {shard.global_shape})")
        kw = {"shard": (first, b, big)}
    u = philox_rand(derive_seed(seed, "train", "sigma"), (batch.shape[0],),
                    device=batch.device, dtype=batch.dtype, **kw)
    if shard is not None:
        kw = {"shard": shard.runs(batch.shape[-2], batch.shape[-1])}
    eps = philox_randn(derive_seed(seed, "train", "eps"), batch.shape,
                       device=batch.device, dtype=batch.dtype, **kw)
    return u, eps


def _fma(a: float, u: torch.Tensor, b: float) -> torch.Tensor:
    """``a + u·b`` rounded once to ``u``'s dtype: XLA's compiled step contracts
    it into a fused multiply-add, and the sigma embedding's angles turn the
    ulps of a twice-rounded value into differences of ~1e-5 (float64 holds
    the float32 product exactly)."""
    return (a + u.double() * b).to(u.dtype)


def _compute_view(model: torch.nn.Module, dtype) -> torch.nn.Module:
    """``model`` computing in ``dtype``: a shallow copy that shares every
    submodule and parameter and differs in ``cfg.dtype`` alone."""
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, dtype=dtype)
    return view


def make_train_step(
    cfg,
    *,
    sigma_min: float = 0.03,
    sigma_max: float = 14.6,
    remat: bool | str = False,
    compute_dtype: Any = None,
    objective: str = "eps",
    flow_shift: float = 1.0,
    timestep_multiplier: float = 1000.0,
    aux_weight: float = 0.01,
    pp_mesh=None,
    microbatches: int = 1,
) -> Callable:
    """Returns ``train_step(model, opt_state, batch, seed) -> loss``: one
    optimizer step on the module in place; ``opt_state`` is the optimizer
    from :func:`init_train_state`, ``batch`` clean latents (B,C,H,W),
    ``seed`` an integer, and ``loss`` a float32 0-dim tensor on the batch's
    device. ``cfg`` is the model's config: a :class:`DiTConfig` with
    ``num_experts > 0`` adds ``aux_weight`` × the Switch load-balance loss.

    Sharded training (one process a rank, every rank calls the step):

    - ``model`` may be this rank's part of a sharded module: the UNet from
      :func:`~sonar_tpu_torch.parallel.shard_unet_params` (tp, FSDP) or the
      DiT from :func:`~sonar_tpu_torch.models.shard_dit_params` (tp, ep;
      with ``pp_mesh``, a mesh with a ``"pp"`` axis, its pipeline stage, run
      by :func:`dit_pp_apply` with ``microbatches``, and tp inside a stage
      where its blocks are split on it). Its layers run their collectives,
      and gradients flow back through them.
    - ``batch`` may be a ``DTensor`` split on its batch dimension (dp): the
      rank's draws are its slice of the whole batch's (:func:`train_draws`),
      the loss is the whole batch's mean (the MoE aux the whole batch's),
      the gradients of the parameters whole on every dp rank are summed over
      dp in one ``all_reduce``, and an FSDP weight's gradient arrives summed
      by its gather's backward. FSDP needs the batch split on its axis.
    - The optimizer steps this rank's blocks: Adam is elementwise, so a
      block's update is the slice of the whole tensor's.

    ``objective`` picks the parametrization the trained weights expect at
    sampling time:

    - ``"eps"``: noise prediction with EDM input scaling, log-uniform sigmas
      in [sigma_min, sigma_max]; pair with ``prediction="eps"``.
    - ``"flow"``: rectified-flow matching (SD3/Flux): t uniform in (0, 1]
      warped by ``time_snr_shift(flow_shift, t)``, input
      ``(1-t)·x0 + t·eps`` unscaled, the network conditioned on
      ``t · timestep_multiplier``, target ``eps - x0``; pair with
      ``prediction="flow", timestep_fn=Flow(...).timestep``.

    ``remat`` recomputes the forward in the backward: ``True``/``"full"``
    checkpoints the whole apply and saves nothing inside it; ``"dots"`` saves
    the outputs of the matmuls with no batch dimension and recomputes the
    rest; ``False`` disables. Gradients are equal either way. In PyTorch a
    checkpoint around the whole forward recomputes every activation at once
    in the backward, so neither setting lowers the peak memory of a step
    (equal peaks for DiT-S/2 at batch 16 on an H100, PERF.md §6); both cost
    time.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): the module keeps float32
    master weights, the forward runs on copies cast to ``compute_dtype``
    (``torch.func.functional_call``), and the gradients land in float32
    through the casts; the loss reduces in float32."""
    if objective not in ("eps", "flow"):
        raise ValueError(f"objective must be 'eps' or 'flow', got {objective!r}")
    if pp_mesh is not None and compute_dtype is not None:
        raise NotImplementedError("make_train_step: compute_dtype with pp_mesh (the pipeline "
                                  "runs the stage's own float32 weights)")
    moe_aux = getattr(cfg, "num_experts", 0) > 0
    # the constants as float32 host scalars, as JAX takes them
    log_lo = np.log(np.float32(sigma_min))
    log_span = float(np.log(np.float32(sigma_max)) - log_lo)
    log_lo = float(log_lo)
    t_span = -float(np.float32(1.0 - 1e-4))

    def forward(model, x, cond, dp):
        if pp_mesh is not None:
            dp_axis = "dp" if "dp" in pp_mesh.mesh_dim_names else None
            tp = next((blk.tp[1] for blk in model.blocks if blk.tp is not None), None)
            return dit_pp_apply(model, x, cond, pp_mesh, microbatches=microbatches,
                                dp=dp_axis, tp=tp, return_aux=moe_aux)
        kwargs = {} if not moe_aux else {"return_aux": True, "dp": dp}
        if compute_dtype is None:
            return model(x, cond, **kwargs)
        cast = {k: p.to(compute_dtype) for k, p in model.named_parameters()}
        return torch.func.functional_call(_compute_view(model, compute_dtype), cast, (x, cond),
                                          kwargs)

    apply = _remat_apply(remat, forward)

    def loss_fn(model, batch, seed, shard):
        u, eps = train_draws(seed, batch) if shard is None else train_draws(seed, batch, shard)
        if objective == "flow":
            # t in (0, 1] (t = 0 is degenerate: no noise, no signal to match)
            t = time_snr_shift(flow_shift, _fma(1.0, u, t_span))
            t4 = t.reshape(-1, 1, 1, 1)
            net_in = (1.0 - t4) * batch + t4 * eps
            cond = t * timestep_multiplier
            target = eps - batch
        else:
            sigma = torch.exp(_fma(log_lo, u, log_span))
            s4 = sigma.reshape(-1, 1, 1, 1)
            net_in = (batch + s4 * eps) / torch.sqrt(1.0 + s4**2)
            cond = sigma
            target = eps
        dp = None if shard is None else (shard.groups, shard.global_shape[0])
        out = apply(model, net_in, cond, dp)
        if moe_aux:
            out, aux = out
        loss = torch.mean((out.float() - target.float()) ** 2)
        if shard is not None:  # the whole batch's mean (the aux is already the whole batch's)
            loss = reduce_from_groups(loss, shard.groups) * (
                shard.local_shape[0] / shard.global_shape[0])
        return loss + aux_weight * aux if moe_aux else loss

    def train_step(model, opt_state, batch, seed):
        shard = None
        if isinstance(batch, DTensor):
            shard = LatentShard.of(batch)
            batch = batch.to_local()
            if not shard.groups:
                shard = None  # replicated on every axis: each rank steps the whole batch
        fsdp = getattr(model, "fsdp_params", frozenset())
        if fsdp and (shard is None or model.fsdp_group not in shard.groups):
            raise ValueError("make_train_step: the model's FSDP layout sums its gradients "
                             "over its axis, and the batch is not split on that axis")
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, seed, shard)
        loss.backward()
        if shard is not None:
            _sum_grads(model, shard.groups, skip=fsdp)
        opt_state.step()
        return loss.detach()

    return train_step


def _sum_grads(model: torch.nn.Module, groups, skip=frozenset()) -> None:
    """Sum the gradients of ``model``'s parameters (but ``skip``) over
    ``groups`` in one flat ``all_reduce`` (a missing gradient counts as
    zeros, so every rank sends the same layout)."""
    params = [p for n, p in model.named_parameters() if p.requires_grad and n not in skip]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = all_reduce(flat, groups)
    i = 0
    for p in params:
        p.grad = flat[i:i + p.numel()].view_as(p)
        i += p.numel()


def init_train_state(model: torch.nn.Module,
                     optimizer: Callable | None = None) -> torch.optim.Optimizer:
    """The optimizer over ``model``'s parameters: ``optimizer`` is a callable
    that builds one from an iterable of parameters (e.g.
    ``functools.partial(torch.optim.Adam, lr=2e-3)``); the default is Adam
    at 1e-4 with optax.adam's betas (0.9, 0.999) and eps 1e-8."""
    make = optimizer or functools.partial(torch.optim.Adam, lr=1e-4)
    return make(model.parameters())


@torch.no_grad()
def ema_update(ema_params: dict, params: dict, decay: float = 0.999) -> dict:
    """One EMA step on state dicts: ``ema ← decay·ema + (1−decay)·params``
    per entry. Sample from the EMA weights, train the raw ones; start with
    ``ema = {k: v.clone() for k, v in model.state_dict().items()}``."""
    return {k: e * decay + params[k].to(e.dtype) * (1.0 - decay)
            for k, e in ema_params.items()}
