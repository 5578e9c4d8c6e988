"""The check that decides ``correct``: the plain reference, run again over
a sample of the calls the window served, from the same seeds, and compared
with what the program produced.

The reference is found by the names the cell's files give: the network
``reference/<family>.py``, the guided denoiser ``reference/pipelines/<pipeline>.py``,
the sampler ``reference/samplers/<sampler>.py`` (given
``ancestral_mode="rf"`` under a flow ``model_sampling`` where it takes that
knob, as ``SonarPipeline`` does the port's) and the noise
``reference/noise/<noise>.py``. It runs in float32 with both TF32 switches off, on weights it makes again
from the seed (the program's own tensors may have been changed in place by
it), after the program is freed. The number compared is ``latent_gap``: the
widest elementwise gap between the program's final latent and the
reference's, over the reference's root mean square, the largest over the
checked calls. Its limit is the cell's (``limits/<cell>.json``), set from
readings of the program and of the control (``calibrate.py``).
"""

from __future__ import annotations

import importlib
import inspect

import torch

from . import traffic as traffic_mod
from . import weights


def reference_sampler(config: dict, traffic: dict, seed: int, device, dtype=torch.float32):
    """``run(call_index, sigmas) -> final latent`` of the reference for this
    cell and seed, its network in ``dtype``."""
    ref = importlib.import_module(f"benchmark.reference.{config['family']}")
    pipeline = importlib.import_module(f"benchmark.reference.pipelines.{traffic['pipeline']}")
    sampler = importlib.import_module(f"benchmark.reference.samplers.{traffic['sampler']}")
    noise = importlib.import_module(f"benchmark.reference.noise.{traffic['noise']}")
    params = weights.make(ref.param_specs(config), seed, device)
    denoise = pipeline.denoiser(ref.network, params, config, traffic, dtype)
    kw = dict(traffic.get("sonar_config", {}))
    if (traffic_mod.model_sampling(traffic) is not None
            and "ancestral_mode" in inspect.signature(sampler.sample).parameters):
        kw.setdefault("ancestral_mode", "rf")

    def run(index, sigmas):
        s = traffic_mod.call_seed(seed, index)
        x0 = traffic_mod.start_latent(traffic, s, float(sigmas[0]), device)
        draws = noise.sampler(s, x0.shape, device, **traffic.get("noise_params", {}))
        return sampler.sample(denoise, x0, sigmas, noise=draws, **kw)

    return run


def gap(out: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double()
    return float((out.to(want.device).double() - want).abs().max()
                 / want.square().mean().sqrt())


@torch.no_grad()
def compare(config: dict, traffic: dict, seed: int, sigmas, calls, device, limits: dict) -> dict:
    """Each of ``calls`` = ``[(index, program output), ...]`` against the
    reference: ``{"checks": {name: {"value", "limit"}}, "per_call": [...]}``."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        run = reference_sampler(config, traffic, seed, device)
        per_call = []
        limit = float(limits["latent_gap"]["limit"])
        for index, out in calls:
            g = gap(out, run(index, sigmas))
            finite = bool(torch.isfinite(out).all())
            per_call.append({"index": index, "latent_gap": g, "ok": finite and g <= limit})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = max((c["latent_gap"] for c in per_call), default=float("nan"))
    return {"checks": {"latent_gap": {"value": worst, "limit": limit}}, "per_call": per_call}
