"""Faults planted under an otherwise whole run of a cell, which the check
that decides ``correct`` has to catch (``calibrate.py --faults``, and
``tests/test_portbench_faults.py`` at a small size on the CPU). Each is a
list of ``(owner, attribute, replacement)`` patches, undone after the run,
found for any configuration and traffic by the names their files give:

- ``control``: the family's reference network (``reference/<family>.py``)
  in bfloat16, the precision below the configurations' float32, in the
  program's place as its denoisers (``families/<family>.py build``): the
  traffic's prediction around it and its CFG mode (``pair``, ``batched`` or
  ``none``, ``families/_common.py guided_models``), the port's pipeline,
  sampler and noise around those;
- ``step_unchanged``: every sampler step returns its state unchanged (the
  step loop of ``samplers/sonar.py``, which the VP path through kernel B1
  and the rectified-flow composed path both run);
- ``half_batch`` (where a call holds two images or more): half of the
  images left out, each model call computing the first half of its rows
  (of each of cond and uncond in a doubled batch) and handing them to the
  rest;
- ``answer_altered``: one element of the final latent negated where the
  pipeline returns it;
- ``attention_axis``: one layer kind wrong, the network's attention taking
  its softmax over the queries instead of the keys, in every block
  (``families/<family>.py attention_axis``).

No cell crosses chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

NAMES = ("control", "step_unchanged", "half_batch", "answer_altered", "attention_axis")


def applies(fault: str, traffic: dict) -> bool:
    return fault != "half_batch" or traffic["shape"][0] >= 2


def _reference_denoiser(network, *, prediction: str, timestep_fn=None):
    """The port's ``make_denoiser`` contract over a plain network, with the
    reference's prediction arithmetic."""
    from .reference import prediction as pred

    def den(x, sigma, **kw):
        sb = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sb = sb.reshape(-1).expand(x.shape[0])
        s4 = sb.reshape(-1, 1, 1, 1)
        c = sb if timestep_fn is None else timestep_fn(sb)
        return x - s4 * network(pred.network_input(prediction, x, s4), c, **kw)

    return den


def _control_build(config, params, traffic, device):
    from .families._common import guided_models

    ref = importlib.import_module(f"benchmark.reference.{config['family']}")
    p = {k: v.to(torch.bfloat16) for k, v in params.items()}

    def network(xin, c, **_):
        return ref.network(p, config, xin, c, torch.bfloat16)

    return guided_models(_reference_denoiser, network, traffic, device)


def _half_rows(inner, groups: int):
    """``inner`` on the first half of each of ``groups`` equal row groups,
    the rows repeated over the group."""

    def half(x, sb, **k):
        n = x.shape[0] // groups
        idx = torch.tensor([g * n + i % (n // 2) for g in range(groups) for i in range(n)],
                           device=x.device)
        return inner(x[idx], sb.reshape(-1).expand(x.shape[0])[idx], **k)

    return half


def patches(fault: str, config: dict, traffic: dict) -> list[tuple[object, str, object]]:
    if fault == "control":
        family = importlib.import_module(f"benchmark.families.{config['family']}")
        return [(family, "build", _control_build)]
    if fault == "step_unchanged":
        from sonar_tpu_torch.samplers import sonar

        real_loop = sonar._run_loop

        def unchanged(step_fn, *a, **k):
            return real_loop(lambda carry, i: (carry, step_fn(carry, i)[1]), *a, **k)

        return [(sonar, "_run_loop", unchanged)]
    if fault == "half_batch":
        from . import harness

        real = harness.build

        def build(*args, **kw):
            pipe, sigmas = real(*args, **kw)
            for attr, groups in (("model", 1), ("model_uncond", 1), ("model_batched", 2)):
                if getattr(pipe, attr) is not None:
                    setattr(pipe, attr, _half_rows(getattr(pipe, attr), groups))
            return pipe, sigmas

        return [(harness, "build", build)]
    if fault == "answer_altered":
        from sonar_tpu_torch.api.pipeline import SonarPipeline

        real_call = SonarPipeline.__call__

        def altered(self, *a, **k):
            out = real_call(self, *a, **k).clone()
            out.view(-1)[17] = -out.view(-1)[17]
            return out

        return [(SonarPipeline, "__call__", altered)]
    if fault == "attention_axis":
        family = importlib.import_module(f"benchmark.families.{config['family']}")
        if not hasattr(family, "attention_axis"):
            raise LookupError(f"benchmark/families/{config['family']}.py has no "
                              "attention_axis(): that fault cannot be planted")
        return family.attention_axis()
    raise ValueError(f"no fault {fault!r}: one of {NAMES}")


@contextlib.contextmanager
def planted(fault: str | None, config: dict, traffic: dict):
    """``fault``'s patches in place for the ``with`` body (none for ``None``)."""
    done = []
    try:
        for owner, attr, value in patches(fault, config, traffic) if fault else []:
            done.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, value)
        yield
    finally:
        for owner, attr, value in reversed(done):
            setattr(owner, attr, value)
