"""CFG-time latent-operation application (port of ``sonar_tpu.api.guider``;
reference SonarApplyLatentOperationCFG, py/nodes/latent_operations.py:22-316).

Returns a patch function and where it installs (``hook``):

- ``post_cfg``: modes denoised / denoised_sub_uncond; ``patch(args)``
  replaces the denoised result after the CFG combine;
- ``pre_cfg``: the cond/uncond modes; ``patch(args)`` edits ``conds_out``;
- ``model_input``: ``patch(args)`` edits the latent fed to the model.

The sigma gate and the blend scale's time curve are host decisions on the
step's host sigma (``args["sigma_host"]``, which the pipeline carries; a
card tensor is read back without it), in float32 as the JAX package's
traced scalars: where the JAX package selects with ``jnp.where``, the port
branches.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..cfg.latent_ops import SonarLatentOperation
from ..core.blend import BLENDING_MODES
from ..utils.misc import fallback, host_sigma

f32 = np.float32


def _blend_scaling(*, model_sampling, scale_mode, sigma, start_sigma, end_sigma, offset,
                   min_pct, max_pct):
    """Time-curve blend scaling (py/nodes/latent_operations.py:120-155) of
    the clipped float32 host sigma."""
    if scale_mode == "none":
        return 1.0
    if scale_mode in {"sampling", "sampling_sin", "reverse_sampling"}:
        rev = np.clip(f32(model_sampling.timestep(sigma)) / f32(999), f32(0), f32(1))
        result = f32(1.0) - rev if scale_mode == "sampling" else rev
    elif scale_mode in {"enabled_range", "enabled_range_sin", "reverse_enabled_range"}:
        rev = (sigma - f32(end_sigma)) / f32(start_sigma - end_sigma)
        result = f32(1.0) - rev if scale_mode == "enabled_range" else rev
    else:
        raise ValueError("Bad blend_scale_mode")
    if scale_mode.endswith("_sin"):
        result = np.sin(result * f32(math.pi))
    return np.clip(result + f32(offset), f32(min_pct), f32(max_pct))


def make_latent_op_cfg_function(
    *,
    operation=None,
    operations: Sequence = (),
    mode: str = "cond_sub_uncond",
    pred_flip_mode: bool = False,
    require_uncond: bool = False,
    start_sigma: float = -1.0,
    end_sigma: float = 0.0,
    blend_mode: str = "lerp",
    blend_strength: float = 0.5,
    blend_scale_mode: str = "reverse_sampling",
    blend_scale_offset: float = 0.0,
    blend_scale_min: float = 0.0,
    blend_scale_max: float = 1.0,
    immediate_blend: bool = False,
    model_sampling=None,
) -> tuple[Callable, str]:
    """Build (patch_fn, hook). ``patch_fn(args)`` takes the CFG args dict:
    input / sigma / sigma_host / denoised / uncond_denoised (post-CFG) or
    conds_out (pre-CFG)."""
    if mode == "model_input":
        if require_uncond:
            raise ValueError("require_uncond does not make sense for the model_input mode.")
        if pred_flip_mode:
            raise ValueError("pred_flip does not make sense for the model_input mode.")
    ops = tuple(
        SonarLatentOperation(op=o)
        for o in ((operation,) if operation is not None else ()) + tuple(operations)
        if o is not None
    )
    post_cfg_mode = mode in {"denoised", "denoised_sub_uncond"}
    hook = "post_cfg" if post_cfg_mode else ("model_input" if mode == "model_input"
                                             else "pre_cfg")
    if not ops:
        # the reference returns the model unpatched when no operations are
        # connected (latent_operations.py:193-195): a pass-through patch
        def passthrough(args: dict):
            if mode == "model_input":
                return args["input"]
            return args["denoised"] if post_cfg_mode else args.get("conds_out", ())

        return passthrough, hook
    blend_function = BLENDING_MODES[blend_mode]
    orig_mode = mode

    def patch(args: dict):
        ms = fallback(args.get("model_sampling"), model_sampling)
        sigma_max = float(ms.sigma_max)
        sigma_min = float(ms.sigma_min)
        ss = sigma_max if start_sigma < 0 else max(sigma_min, min(sigma_max, start_sigma))
        es = max(sigma_min, min(sigma_max, end_sigma))
        ss, es = (es, ss) if es > ss else (ss, es)
        scale_mode = "none" if ss == es else blend_scale_mode

        x = args["input"]
        sigma_t = torch.as_tensor(args["sigma"], device=x.device)
        sigma_b = sigma_t.reshape((-1,) + (1,) * (x.ndim - 1)) if \
            sigma_t.ndim < x.ndim else sigma_t
        s = f32(host_sigma(args))
        conds_out = args.get("conds_out", ())
        uncond = (args.get("uncond_denoised") if post_cfg_mode
                  else (conds_out[1] if len(conds_out) > 1 else None))
        mode_now = orig_mode
        if uncond is None:
            if require_uncond or mode_now in {"uncond", "uncond_sub_cond",
                                              "denoised_sub_uncond"}:
                return args["denoised"] if post_cfg_mode else conds_out
            if mode_now.endswith("_sub_uncond"):
                mode_now = mode_now.split("_", 1)[0]
        cond = conds_out[0] if (not post_cfg_mode and len(conds_out)) else None
        if mode_now == "model_input":
            t1, t2 = x, None
        elif mode_now in {"cond", "cond_sub_uncond"}:
            t1 = cond
            t2 = uncond if mode_now == "cond_sub_uncond" else None
        elif mode_now in {"uncond", "uncond_sub_cond"}:
            t1 = uncond
            t2 = cond if mode_now == "uncond_sub_cond" else None
        else:
            t1 = args["denoised"]
            t2 = uncond if mode_now == "denoised_sub_uncond" else None
        if not f32(es) <= s <= f32(ss):
            result = t1
        else:
            t1_orig = t1
            if pred_flip_mode:
                t1 = (x - t1) / sigma_b
                if t2 is not None:
                    t2 = (x - t2) / sigma_b
            curr_blend = float(f32(blend_strength) * _blend_scaling(
                model_sampling=ms, scale_mode=scale_mode,
                sigma=np.clip(s, f32(sigma_min), f32(sigma_max)),
                start_sigma=ss, end_sigma=es, offset=blend_scale_offset,
                min_pct=blend_scale_min, max_pct=blend_scale_max))
            result = t1 - t2 if t2 is not None else t1
            for op in ops:
                curr = op(result, sigma=sigma_t, t2=t2, cond=cond, uncond=uncond,
                          cond_scale=args.get("cond_scale"), raw_args=args)
                result = blend_function(result, curr, curr_blend) if immediate_blend else curr
            if t2 is not None:
                result = result + t2
            if pred_flip_mode:
                result = x - sigma_b * result
            if not immediate_blend:
                result = blend_function(t1_orig, result, curr_blend)
        if post_cfg_mode or mode_now == "model_input":
            return result
        out = list(conds_out)
        out[0 if mode_now.startswith("cond") else 1] = result
        return out

    return patch, hook
