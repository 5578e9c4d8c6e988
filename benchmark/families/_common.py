"""What the families share: putting the benchmark's weights into the port's
module, and the two ways of making the uncond side of the guidance."""

from __future__ import annotations

import torch
from torch import nn


def load_weights(module: nn.Module, params: dict[str, torch.Tensor]) -> nn.Module:
    """``module`` (built on the meta device) holding ``params`` as its
    parameters, by name and shape, with no copy; every parameter must be
    given and every given tensor used."""
    names = {n for n, _ in module.named_parameters()}
    if names != set(params):
        raise ValueError(f"weights and module disagree: missing {sorted(names - set(params))[:5]}, "
                         f"extra {sorted(set(params) - names)[:5]}")
    for name, p in list(module.named_parameters()):
        t = params[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: weight {tuple(t.shape)}, module {tuple(p.shape)}")
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    return module.eval()


def guided_models(make_denoiser, module, traffic: dict, device) -> dict:
    """The pipeline's model callables for ``traffic["cfg"]``: ``pair`` gives
    a cond denoiser and an uncond one whose network input is scaled by
    ``uncond_input_scale``; ``batched`` gives one denoiser of the doubled
    batch whose rows ``[B:]`` are scaled so."""
    cfg = traffic["cfg"]
    s = float(cfg["uncond_input_scale"])
    if cfg["mode"] == "pair":
        return {"model": make_denoiser(module),
                "model_uncond": make_denoiser(lambda xin, c, **kw: module(xin * s, c, **kw))}
    if cfg["mode"] == "batched":
        b = traffic["shape"][0]
        rows = torch.tensor([1.0] * b + [s] * b, device=device).reshape(-1, 1, 1, 1)
        return {"model_batched": make_denoiser(
            lambda xin, c, **kw: module(xin * rows, c, **kw))}
    raise ValueError(f"cfg mode {cfg['mode']!r}: 'pair' or 'batched'")
