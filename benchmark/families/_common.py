"""What the families share: putting the benchmark's weights into the port's
module, the port's model sampling for the traffic, and the denoisers each
CFG mode hands the pipeline."""

from __future__ import annotations

import torch
from torch import nn

from .. import traffic as traffic_mod


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


def flow(traffic: dict):
    """The port's ``Flow`` for a flow ``model_sampling`` (``traffic.py``),
    or None for a discrete model: the pipeline's model sampling and, by its
    ``timestep``, what the denoisers condition the network on."""
    ms = traffic_mod.model_sampling(traffic)
    if ms is None:
        return None
    from sonar_tpu_torch.cfg import Flow

    return Flow(multiplier=float(ms["multiplier"]))


def guided_models(make_denoiser, module, traffic: dict, device) -> dict:
    """The pipeline's model callables for ``traffic["cfg"]``: ``none`` gives
    one denoiser; ``pair`` a cond denoiser and an uncond one whose network
    input is scaled by ``uncond_input_scale``; ``batched`` one denoiser of
    the doubled batch whose rows ``[B:]`` are scaled so. Each is
    ``make_denoiser(module, prediction=, timestep_fn=)`` with the traffic's
    prediction (``traffic.py``) and, under flow, ``Flow.timestep``."""
    cfg = traffic["cfg"]
    ms = flow(traffic)
    timestep_fn = None if ms is None else ms.timestep

    def den(m):
        return make_denoiser(m, prediction=traffic_mod.prediction(traffic),
                             timestep_fn=timestep_fn)

    if cfg["mode"] == "none":
        return {"model": den(module)}
    s = float(cfg["uncond_input_scale"])
    if cfg["mode"] == "pair":
        return {"model": den(module),
                "model_uncond": den(lambda xin, c, **kw: module(xin * s, c, **kw))}
    if cfg["mode"] == "batched":
        b = traffic["shape"][0]
        rows = torch.tensor([1.0] * b + [s] * b, device=device).reshape(-1, 1, 1, 1)
        return {"model_batched": den(lambda xin, c, **kw: module(xin * rows, c, **kw))}
    raise ValueError(f"cfg mode {cfg['mode']!r}: 'pair', 'batched' or 'none'")
