"""The one traffic generator: a traffic mix is a JSON file of parameters
under ``benchmark/traffic/``, and everything a run feeds the program (the
sigma schedule, each call's seed and starting latent) comes from it and the
run's ``--seed``.

Keys of a traffic file:

- ``shape`` (B, C, H, W): the latent of one pipeline call (B images at once);
- ``steps``, ``sigma_max``, ``sigma_min``, ``rho``: the Karras schedule,
  ``steps`` sigmas from ``sigma_max`` to ``sigma_min``, then 0;
- ``pipeline`` (``pipelines/<name>.py`` builds it from the program,
  ``reference/pipelines/<name>.py`` is its reference), ``sampler`` (a
  registry name; ``reference/samplers/<name>.py``), ``sonar_config``
  (``SonarConfig`` fields), ``noise`` (a noise type name;
  ``reference/noise/<name>.py``) and ``noise_params``: what the pipeline
  samples with;
- ``cfg``: ``mode`` "pair" (cond and uncond as two calls a step),
  "batched" (one call on the doubled batch) or "none" (one unguided call
  of the B images a step, as a guidance-distilled model runs); with
  guidance ``scale`` and ``uncond_input_scale``, the factor on the network
  input that makes the uncond side;
- ``model_sampling`` (optional): ``{"multiplier": m}`` makes the model a
  rectified-flow one: the pipeline gets the port's ``Flow(multiplier=m)``,
  which gives ancestral samplers the rectified-flow split, the network's
  output is a velocity (CONST: no input scaling, ``denoised = x − σ·out``)
  and the network is conditioned on ``σ·m``. The schedule stays the Karras
  one above, so no key states a resolution shift: nothing would apply it.
  Without the key the model is discrete with eps prediction;
- ``check_calls``: how many of the window's calls the reference checks;
- ``trace_calls``: how many whole calls the traced run profiles.

Calls are a closed loop, one user's queue: the next call starts when the
last one is done.
"""

from __future__ import annotations

import json
import pathlib

import torch

from .reference.philox import derive_seed

HERE = pathlib.Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def model_sampling(t: dict) -> dict | None:
    """The traffic's flow model sampling ``{"multiplier": m}``, or None for
    a discrete (eps) model."""
    ms = t.get("model_sampling")
    if ms is not None and set(ms) != {"multiplier"}:
        raise ValueError(f"model_sampling {sorted(ms)}: only 'multiplier' is read "
                         "(the schedule is Karras from sigma_max/sigma_min; no shift applies)")
    return ms


def prediction(t: dict) -> str:
    """What the network's output means: ``const`` (a velocity) under flow,
    ``eps`` otherwise."""
    return "eps" if model_sampling(t) is None else "const"


def karras_sigmas(t: dict) -> torch.Tensor:
    """The schedule as a float32 CPU tensor: computed in float64, rounded
    once."""
    ramp = torch.linspace(0, 1, t["steps"], dtype=torch.float64)
    lo, hi, rho = t["sigma_min"] ** (1 / t["rho"]), t["sigma_max"] ** (1 / t["rho"]), t["rho"]
    s = (hi + ramp * (lo - hi)) ** rho
    return torch.cat([s, torch.zeros(1, dtype=torch.float64)]).float()


def call_seed(seed: int, index: int | str) -> int:
    """The seed of call ``index`` of a run with ``seed`` (the warm-up call
    is ``"warm"``): the noise stream's seed and the starting latent's."""
    return derive_seed(seed, "call", index)


def start_latent(t: dict, seed: int, sigma_max: float, device) -> torch.Tensor:
    """The call's starting latent, ``sigma_max·N(0, 1)``, drawn on ``device``
    by a generator of that device from the call's seed."""
    g = torch.Generator(device=device).manual_seed(seed & ((1 << 63) - 1))
    return torch.randn(tuple(t["shape"]), generator=g, device=device) * sigma_max
