"""Faults planted under an otherwise whole run of a cell, which the check
that decides ``correct`` has to catch (``calibrate.py --faults``, and
``tests/test_portbench_faults.py`` at a small size on the CPU). Each is a
list of ``(owner, attribute, replacement)`` patches, undone after the run:

- ``control``: the reference's network in bfloat16, the precision below
  the configurations' float32, in the program's place as its denoisers
  (the port's pipeline, sampler and noise around it);
- ``step_unchanged``: a sampler step that returns its state unchanged;
- ``half_batch`` (batched guidance only): half of the images left out, the
  denoiser computing the first half and handing its rows to the rest;
- ``answer_altered``: one element of the final latent negated where the
  pipeline returns it;
- ``attention_axis``: one layer kind wrong, the network's attention taking
  its softmax over the queries instead of the keys, in every block.

No cell crosses chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import torch

NAMES = ("control", "step_unchanged", "half_batch", "answer_altered", "attention_axis")


def applies(fault: str, traffic: dict) -> bool:
    return fault != "half_batch" or traffic["cfg"]["mode"] == "batched"


def _control_build(config, params, traffic, device):
    ref = importlib.import_module(f"benchmark.reference.{config['family']}")
    p = {k: v.to(torch.bfloat16) for k, v in params.items()}
    s = float(traffic["cfg"]["uncond_input_scale"])

    def den(scale):
        def d(x, sb, **_):
            s4 = sb.reshape(-1, 1, 1, 1)
            xin = x / torch.sqrt(s4 * s4 + 1.0)
            return x - s4 * ref.network(p, config, xin * scale, sb, torch.bfloat16)
        return d

    if traffic["cfg"]["mode"] == "pair":
        return {"model": den(1.0), "model_uncond": den(s)}
    b = traffic["shape"][0]
    return {"model_batched": den(torch.tensor([1.0] * b + [s] * b, device=device)
                                 .reshape(-1, 1, 1, 1))}


def _unet_attention_axis(self, x):
    b, c, h, w = x.shape
    n, heads = h * w, self.num_heads
    y = self.norm(x).reshape(b, c, n).transpose(1, 2)
    q, k, v = self.qkv(y).reshape(b, n, 3, heads, c // heads).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / math.sqrt(c // heads)
    attn = torch.softmax(logits, dim=-2).to(x.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
    return x + self.proj(out).transpose(1, 2).reshape(b, c, h, w)


def _dit_attention_axis(self, x):
    b, n, d = x.shape
    dh = d // self.cfg.num_heads
    qkv = self.qkv(x).reshape(b, n, self.cfg.num_heads, 3, dh)
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    att = torch.softmax(logits / math.sqrt(dh), dim=-2)
    return self.attn_out(torch.matmul(att.to(x.dtype), v).transpose(1, 2).reshape(b, n, d))


def patches(fault: str, config: dict, traffic: dict) -> list[tuple[object, str, object]]:
    if fault == "control":
        return [(importlib.import_module(f"benchmark.families.{fam}"), "build", _control_build)
                for fam in ("unet", "dit")]
    if fault == "step_unchanged":
        from sonar_tpu_torch.samplers import sonar

        return [(sonar, "fused_momentum_step", lambda x, den, hd, noise, scal: (x, hd))]
    if fault == "half_batch":
        from . import harness

        real = harness.build

        def build(*args, **kw):
            pipe, sigmas = real(*args, **kw)
            inner = pipe.model_batched

            def half(x, sb, **k):
                b = x.shape[0] // 2  # [cond | uncond] halves of the doubled batch
                h = b // 2
                idx = torch.cat([torch.arange(h), torch.arange(h), torch.arange(b, b + h),
                                 torch.arange(b, b + h)]).to(x.device)
                return inner(x[idx], sb[idx], **k)

            pipe.model_batched = half
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
        if config["family"] == "unet":
            from sonar_tpu_torch.models.unet import Attention

            return [(Attention, "forward", _unet_attention_axis)]
        from sonar_tpu_torch.models.dit import Block

        return [(Block, "attention", _dit_attention_axis)]
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
