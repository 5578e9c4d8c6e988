"""The ops rule engine and BlehOpsNoise (port of
``sonar_tpu.noise.ops_engine``; reference py/noise.py:2190-2241 and
py/nodes/integrations.py:103-182).

A rule program is a list of rules, each a sigma window and a list of ops
applied in order to the noise (``h``); ``blend`` reads ``hsp``, the
reference latent (zeros by default):

```yaml
- when: {sigma_min: 0.0, sigma_max: 14.6}
  ops:
    - [multiply, 1.5]
    - [blend, {mode: lerp, strength: 0.5, source: hsp}]
    - [ffilter, {filter: highpass, threshold: 0.0, scale: 1.0, strength: 1.0}]
    - [enhance, {mode: sharpen, scale: 0.3}]
    - [roll, {dim: -1, amount: 4}]
```

The same program may be given as dicts and lists. A string is read as
YAML, which needs PyYAML (imported only then; without it the build raises
``ImportError``). The window is decided on the host, on the float32 sigma
the sampler passes, and a rule outside it does not run (the JAX package
computes it and selects).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..core.normalize import quantile_normalize, scale_noise
from .base import NoiseItem
from .blendfilter import enhance_tensor, ffilter
from .combinators import _as_device, _memo


def _op_multiply(t, state, arg):
    return t * float(arg)


def _op_add(t, state, arg):
    return t + float(arg)


def _op_blend(t, state, arg):
    arg = arg or {}
    other = state.get(arg.get("source", "hsp"))
    if other is None:
        raise ValueError(f"blend op: unknown source {arg.get('source', 'hsp')!r}")
    return BLENDING_MODES[arg.get("mode", "lerp")](t, other, float(arg.get("strength", 0.5)))


def _op_ffilter(t, state, arg):
    arg = arg or {}
    return ffilter(t, float(arg.get("threshold", 0.0)), float(arg.get("scale", 1.0)),
                   arg.get("filter", "none"), float(arg.get("strength", 1.0)))


def _op_enhance(t, state, arg):
    arg = arg or {}
    return enhance_tensor(t, arg.get("mode", "none"), float(arg.get("scale", 1.0)),
                          sigma=state.get("sigma"))


def _op_roll(t, state, arg):
    arg = arg or {}
    return torch.roll(t, int(arg.get("amount", 1)), dims=int(arg.get("dim", -1)))


def _op_flip(t, state, arg):
    arg = arg or {}
    return torch.flip(t, dims=(int(arg.get("dim", -1)),))


def _op_normalize(t, state, arg):
    arg = arg or {}
    return scale_noise(t, float(arg.get("factor", 1.0)), normalized=True)


def _op_quantile(t, state, arg):
    arg = arg or {}
    return quantile_normalize(t, quantile=float(arg.get("quantile", 0.85)),
                              dim=arg.get("dim", 1), flatten=bool(arg.get("flatten", True)),
                              strategy=arg.get("strategy", "clamp"))


def _op_abs(t, state, arg):
    return torch.abs(t)


def _op_neg(t, state, arg):
    return -t


OPS_TABLE = {
    "multiply": _op_multiply,
    "add": _op_add,
    "blend": _op_blend,
    "ffilter": _op_ffilter,
    "enhance": _op_enhance,
    "roll": _op_roll,
    "flip": _op_flip,
    "normalize": _op_normalize,
    "quantile": _op_quantile,
    "abs": _op_abs,
    "neg": _op_neg,
}


@dataclasses.dataclass(frozen=True)
class OpsRule:
    ops: tuple = ()
    sigma_min: float | None = None
    sigma_max: float | None = None

    @classmethod
    def build(cls, spec: dict) -> "OpsRule":
        when = spec.get("when", {}) or {}
        ops = []
        for op in spec.get("ops", ()):
            if isinstance(op, str):
                name, arg = op, None
            else:
                name, *rest = op
                arg = rest[0] if rest else None
            if name not in OPS_TABLE:
                valid = ", ".join(sorted(OPS_TABLE))
                raise ValueError(f"Unknown op {name!r}; valid: {valid}")
            ops.append((name, arg))
        return cls(ops=tuple(ops), sigma_min=when.get("sigma_min"),
                   sigma_max=when.get("sigma_max"))

    def matches(self, state) -> bool:
        """Whether the window holds the state's sigma (a host number, or the
        largest of a sequence), compared in float32 as the JAX package
        compares its traced sigma."""
        sigma = state.get("sigma")
        if sigma is None:
            return True
        s = np.float32(np.max(np.asarray(sigma, dtype=np.float64)))
        return ((self.sigma_min is None or s >= np.float32(self.sigma_min))
                and (self.sigma_max is None or s <= np.float32(self.sigma_max)))

    def apply(self, state) -> dict:
        if not self.matches(state):
            return state
        out = state["h"]
        for name, arg in self.ops:
            out = OPS_TABLE[name](out, state, arg)
        return {**state, "h": out}


@dataclasses.dataclass(frozen=True)
class OpsRuleGroup:
    rules: tuple = ()

    @classmethod
    def build(cls, specs) -> "OpsRuleGroup":
        if isinstance(specs, str):
            import yaml

            specs = yaml.safe_load(specs) or ()
        if isinstance(specs, dict):
            specs = (specs,)
        return cls(rules=tuple(OpsRule.build(s) for s in specs))

    def eval(self, state: dict) -> dict:
        for rule in self.rules:
            state = rule.apply(state)
        return state


class BlehOpsNoise(NoiseItem):
    """Runs a rule program on the child's noise (py/noise.py:2190-2241).
    ``hsp`` in the program's state is zeros, or ``reference`` where given
    (copied to the device once per device and type)."""

    def __init__(self, factor=1.0, *, noise, rules, normalize=None, reference=None):
        if hasattr(noise, "items") and not noise.items:
            raise ValueError("BlehOpsNoise requires at least one noise item")
        super().__init__(factor, normalize=normalize, noise=noise,
                         rules=rules if isinstance(rules, OpsRuleGroup)
                         else OpsRuleGroup.build(rules),
                         reference=reference)
        self._refs = {}

    def check_dims(self, ctx):
        super().check_dims(ctx)
        self.noise.check_dims(ctx)

    SHARDABLE = True  # draws a rank's block of a sharded latent (base module docstring)

    def init_state(self, ctx, seed):
        return {"inner": self.noise.init_state(ctx, seed)}

    def _hsp(self, ctx, like):
        if self.reference is None:
            return torch.zeros_like(like)
        return _memo(self._refs, ctx, lambda: _as_device(self.reference, ctx))

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        normalize = self.get_normalize("normalize", normalized)
        noise, st = self.noise.sample(ctx, state["inner"], seed, sigma, sigma_next,
                                      normalized=False)
        if self.rules.rules:
            # a rule may take statistics of the whole latent (a quantile, a
            # normalization): the program runs on the ranks' gathered blocks
            def run(h):
                return self.rules.eval({"h": h, "hsp": self._hsp(ctx, h), "sigma": sigma})["h"]

            noise = ctx.on_whole(run, noise)
        return (scale_noise(noise, self.factor, normalized=bool(normalize), shard=ctx.shard),
                {**state, "inner": st})
