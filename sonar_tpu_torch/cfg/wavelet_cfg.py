"""Wavelet CFG (port of ``sonar_tpu.cfg.wavelet_cfg``; reference
py/wavelet_cfg.py): per-frequency-band, per-orientation CFG scales with
schedulable interpolation.

What the port decides on the host:

- **Rule choice.** The JAX package traces every rule through ``lax.switch``
  on a traced first-match index. Here the sampler hands the step's sigma to
  the CFG function as a host number (``args["sigma_host"]``, beside the
  device batch ``args["sigma"]``), the first matching rule is picked on the
  host and only its branch runs. A call reads nothing back from the card;
  without ``sigma_host`` the largest sigma of the batch is read once.
- **Percentages and schedules** are host scalars computed in float32 with
  the JAX package's order of operations (its traced scalars are float32), so
  the step-percentage modes use the float32 arithmetic of the JAX
  package's ``step_from_sigmas_traced`` (``utils.misc.step_from_sigmas_f32``),
  not the host ``step_from_sigmas``, which rounds to 2 decimals.
- **Precision.** ``high_precision_mode=True`` transforms in float64, as the
  reference does and as the JAX package does under ``jax_enable_x64``;
  otherwise in the latent's type promoted to float32.

The wavelet transforms are the port's DWT (exact float32 products and sums,
no TF32 path: see ``wavelets/dwt.py``). Config objects keep the reference's
YAML key names so rule documents port verbatim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..core.blend import BLENDING_MODES
from ..utils.misc import clamp_float, fallback, filter_dict, host_sigma, step_from_sigmas_f32
from ..wavelets import Wavelet, expand_yh_scales, wavelet_scaling
from .model_sampling import ContinuousEDM

f32 = np.float32

# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

_SCHEDULES = ("linear", "logarithmic", "log", "exponential", "exp",
              "half_cosine", "sine", "sin")


def _clamp01(v):
    return np.clip(f32(v), f32(0.0), f32(1.0))


def schedule_interp(name: str, val):
    """py/wavelet_cfg.py:42-57 on a float32 host scalar."""
    val = _clamp01(val)
    name = name.lower()
    if name == "linear":
        return val
    if name in ("logarithmic", "log"):
        out = f32(0.0) if val == 0 else np.log(np.maximum(val, f32(1e-30))) + f32(1.0)
    elif name in ("exponential", "exp"):
        out = np.exp(val) - f32(1.0)
    elif name == "half_cosine":
        out = f32(1.0) - (f32(1.0) + np.cos(val * f32(math.pi))) / f32(2.0)
    elif name in ("sine", "sin"):
        out = np.sin(val * f32(math.pi))
    else:
        raise ValueError("Bad interpolation schedule!?")
    return _clamp01(out)


_SCHED_MODE_ALIASES = {
    "sampling": "sampling", "model_sampling": "sampling",
    "enabled_sampling": "enabled_sampling",
    "enabled_model_sampling": "enabled_sampling",
    "sigmas": "sigmas", "sigma_range": "sigmas",
    "enabled_sigmas": "enabled_sigmas", "enabled_sigma_range": "enabled_sigmas",
    "step": "steps", "steps": "steps", "enabled_steps": "enabled_steps",
}


# ---------------------------------------------------------------------------
# Percentages (py/wavelet_cfg.py:81-211): float32 host scalars
# ---------------------------------------------------------------------------


def _pct_of(ms, sigma) -> np.float32:
    return f32(1.0) - np.clip(f32(ms.timestep(f32(sigma))) / f32(999), f32(0), f32(1))


@dataclasses.dataclass(frozen=True)
class WCFGPercentages:
    pct_sampling: Any
    pct_enabled_sampling: Any
    pct_sigmas: Any = None
    pct_enabled_sigmas: Any = None
    pct_steps: Any = None
    pct_enabled_steps: Any = None

    def invert(self) -> "WCFGPercentages":
        inv = lambda v: None if v is None else f32(1.0) - v  # noqa: E731
        return WCFGPercentages(**{f.name: inv(getattr(self, f.name))
                                  for f in dataclasses.fields(self)})

    def pct_from_schedmode(self, mode: str):
        mode = _SCHED_MODE_ALIASES[mode.lower()]
        val = getattr(self, f"pct_{mode}")
        if val is None:
            raise RuntimeError(f"Percentage for schedule mode {mode!r} not available")
        return val

    @classmethod
    def build(cls, *, ms, start_sigma: float, end_sigma: float, sigma: float,
              sigmas: np.ndarray | None) -> "WCFGPercentages":
        """The percentages of host sigma ``sigma`` in the rule's window
        [end_sigma, start_sigma], in the model's range and, given the step
        table ``sigmas``, in the run's sigmas and steps."""
        if start_sigma < 0:
            start_sigma = math.inf
        if start_sigma < end_sigma:
            start_sigma, end_sigma = end_sigma, start_sigma
        sigma_max, sigma_min = float(ms.sigma_max), float(ms.sigma_min)
        start_sigma = min(sigma_max, start_sigma)
        end_sigma = min(max(sigma_min, end_sigma), sigma_max)
        sigma = np.clip(f32(sigma), f32(sigma_min), f32(sigma_max))
        pct_start, pct_end, pct_curr = (_pct_of(ms, s) for s in (start_sigma, end_sigma, sigma))
        denom = f32(1.0) if pct_end == pct_start else pct_end - pct_start
        kw = {}
        if sigmas is not None:
            sigmas = np.asarray(sigmas, np.float64)
            if sigmas.ndim == 2:
                sigmas = sigmas.max(axis=0)
            elif sigmas.ndim != 1:
                raise ValueError("Unexpected number of dimensions for sample_sigmas")
            sigma_first, sigma_last = float(sigmas[0]), float(sigmas[-2])
            if sigma_first <= sigma_last:
                raise ValueError(
                    "Cannot handle non-descending sigmas (possibly Restart or unsampling)")
            kw["pct_sigmas"] = (f32(sigma_first) - sigma) / f32(sigma_first - sigma_last)
            start_sigma = min(start_sigma, sigma_first)
            end_sigma = max(end_sigma, sigma_last)
            sigma_c = np.clip(sigma, f32(sigma_last), f32(sigma_first))
            if start_sigma == end_sigma:
                kw["pct_enabled_sigmas"] = f32(1.0)
            else:
                kw["pct_enabled_sigmas"] = ((f32(start_sigma) - sigma_c)
                                            / f32(start_sigma - end_sigma))
            steps = len(sigmas) - 1
            if steps > 1 and np.any(np.round(sigmas[:-1], 4) <= 0):
                # a non-positive interior sigma: the step is undeterminable for
                # every sigma, so steps modes raise "not available"
                pass
            elif steps > 1:
                step = step_from_sigmas_f32(sigma_c, sigmas)
                # an undetermined step is NaN, as the JAX package makes it
                step = f32("nan") if step is None else f32(step)
                kw["pct_steps"] = step / f32(steps - 1)
                enabled = np.arange(len(sigmas))[(sigmas <= start_sigma) & (sigmas >= end_sigma)]
                if len(enabled) > 1:
                    first, last = int(enabled[0]), int(enabled[-1])
                    kw["pct_enabled_steps"] = (step - f32(first)) / f32(last - first)
            else:
                kw["pct_steps"] = f32(1.0)
        return cls(pct_sampling=pct_curr, pct_enabled_sampling=(pct_curr - pct_start) / denom,
                   **kw)


# ---------------------------------------------------------------------------
# Scales and schedules (py/wavelet_cfg.py:215-465)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WCFGScheduledScale:
    schedule: str = "linear"
    schedule_mode: str = "enabled_sampling"
    schedule_offset: float = 0.0
    schedule_offset_after: float = 0.0
    schedule_multiplier: float = 1.0
    schedule_multiplier_after: float = 1.0
    reverse_schedule: bool = False
    reverse_schedule_after: bool = False
    schedule_min: float = 0.0
    schedule_max: float = 1.0

    @classmethod
    def build(cls, **kwargs) -> "WCFGScheduledScale":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**filter_dict(kwargs, fields))

    def get_b_scale(self, pcts: WCFGPercentages) -> np.float32:
        if self.reverse_schedule:
            pcts = pcts.invert()
        pct = pcts.pct_from_schedmode(self.schedule_mode)
        pct = np.clip(
            (schedule_interp(self.schedule,
                             _clamp01((pct + f32(self.schedule_offset))
                                      * f32(self.schedule_multiplier)))
             + f32(self.schedule_offset_after)) * f32(self.schedule_multiplier_after),
            f32(clamp_float(self.schedule_min)),
            f32(clamp_float(self.schedule_max)),
        )
        if self.reverse_schedule_after:
            pct = _clamp01(f32(1.0) - pct)
        return pct


@dataclasses.dataclass(frozen=True)
class WCFGScales:
    yl_scale: Any = 1.0
    yh_scales: Any = 1.0

    def get_scales(self, *_a, **_kw) -> "WCFGScales":
        return self


def _blend_f32(mode: str, a, b, t) -> float:
    """A blend mode on float32 host scalars (lerp as ``a*(1-t) + b*t``, as
    the JAX package writes it), as a Python float."""
    if mode == "lerp":
        return float(f32(a) * (f32(1.0) - t) + f32(b) * t)
    args = (torch.tensor(float(v), dtype=torch.float32) for v in (a, b, t))
    return float(BLENDING_MODES[mode](*args))


@dataclasses.dataclass(frozen=True)
class WCFGScalesRange:
    scales_start: WCFGScales = WCFGScales()
    scales_end: WCFGScales | None = None
    scheduler: WCFGScheduledScale | None = None
    blend_mode: str = "lerp"

    @classmethod
    def build(cls, **kwargs):
        scales_start = kwargs.pop("scales_start", None)
        if scales_start is None:
            scales_start = {
                "yl_scale": kwargs.pop("yl_scale", 1.0),
                "yh_scales": kwargs.pop("yh_scales", 1.0),
            }
        scales_end = filter_dict(kwargs.pop("scales_end", {}) or {}, ("yl_scale", "yh_scales"))
        if not scales_end or scales_end == scales_start:
            return WCFGScales(yl_scale=scales_start.get("yl_scale", 1.0),
                              yh_scales=scales_start.get("yh_scales", 1.0))
        return cls(
            scales_start=WCFGScales(**scales_start),
            scales_end=WCFGScales(**scales_end),
            scheduler=WCFGScheduledScale.build(**kwargs),
            blend_mode=kwargs.pop("blend_mode", "lerp"),
        )

    def get_scales(self, pcts: WCFGPercentages, yh) -> WCFGScales:
        if self.scales_end is None or self.scheduler is None:
            return self.scales_start
        pct = self.scheduler.get_b_scale(pcts)
        start_yh = expand_yh_scales(yh, yh_scales=self.scales_start.yh_scales)
        end_yh = expand_yh_scales(yh, yh_scales=self.scales_end.yh_scales)
        yl = _blend_f32(self.blend_mode, self.scales_start.yl_scale,
                        self.scales_end.yl_scale, pct)
        yh_scales = tuple(
            tuple(_blend_f32(self.blend_mode, os, oe, pct) for os, oe in zip(bs, be))
            for bs, be in zip(start_yh, end_yh))
        return WCFGScales(yl_scale=yl, yh_scales=yh_scales)


def apply_wcfg_scales(scales: WCFGScales, yl, yh):
    """``wavelet_scaling`` with the scales a rule resolved (host numbers)."""
    return wavelet_scaling(yl, yh, scales.yl_scale, fallback(scales.yh_scales, 1.0))


@dataclasses.dataclass(frozen=True)
class WCFGScheduledFloat:
    value_start: float = 1.0
    value_end: float | None = None
    scheduler: WCFGScheduledScale | None = None

    @classmethod
    def build(cls, val) -> "WCFGScheduledFloat":
        if isinstance(val, (float, int)):
            return cls(value_start=float(val))
        if not isinstance(val, dict):
            raise TypeError("Bad type for scheduled float value")
        val = dict(val)
        value_start = val.pop("value_start", None)
        value_end = val.pop("value_end", None)
        if not isinstance(value_start, (float, int)):
            raise TypeError("Bad type for scheduled float start_value")
        if value_end is None:
            return cls(value_start=float(value_start))
        return cls(value_start=float(value_start), value_end=float(value_end),
                   scheduler=WCFGScheduledScale.build(**val))

    @property
    def is_static(self) -> bool:
        return self.value_end is None or self.scheduler is None

    def get_value(self, pcts: WCFGPercentages):
        if self.is_static:
            return self.value_start
        pct = self.scheduler.get_b_scale(pcts)
        return float((f32(1.0) - pct) * f32(self.value_start) + pct * f32(self.value_end))


# ---------------------------------------------------------------------------
# Rules (py/wavelet_cfg.py:468-618)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WCFGWaveletSettings:
    wave: str = "db4"
    level: int = 5
    padding_mode: str = "symmetric"
    use_1d_dwt: bool = False
    use_dtcwt: bool = False
    biort: str = "near_sym_a"
    qshift: str = "qshift_a"
    inv_wave: str | None = None
    inv_padding_mode: str | None = None
    inv_biort: str | None = None
    inv_qshift: str | None = None

    @classmethod
    def build(cls, **kwargs):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**filter_dict(kwargs, fields))

    def make_wavelet(self) -> Wavelet:
        return Wavelet(
            wave=self.wave, level=self.level, mode=self.padding_mode,
            use_1d_dwt=self.use_1d_dwt, use_dtcwt=self.use_dtcwt,
            biort=self.biort, qshift=self.qshift,
            inv_wave=self.inv_wave, inv_mode=self.inv_padding_mode,
            inv_biort=self.inv_biort, inv_qshift=self.inv_qshift,
        )


_TARGETS = ("denoised", "noise", "noise_norm")


@dataclasses.dataclass(frozen=True)
class WCFGRule:
    start_sigma: float = math.inf
    end_sigma: float = 0.0
    verbose: bool = False
    blend_mode: str = "lerp"
    blend_strength: WCFGScheduledFloat = WCFGScheduledFloat(1.0)
    fallback_existing: bool = True
    target_mode: str = "denoised"
    diff: Any = None
    cond: Any = None
    uncond: Any = None
    final: Any = None
    wavelet: WCFGWaveletSettings = WCFGWaveletSettings()
    high_precision_mode: bool = True
    difference_blend_mode: str = "inject"
    difference_blend_strength: WCFGScheduledFloat = WCFGScheduledFloat(1.0)

    @classmethod
    def build(cls, **kwargs) -> "WCFGRule":
        target_mode = str(kwargs.pop("target_mode", "denoised")).lower()
        if target_mode not in _TARGETS:
            raise ValueError("Bad target mode")
        diff = kwargs.pop("diff", None) or kwargs.pop("difference", None)
        parts = {
            name: (None if val is None else WCFGScalesRange.build(**val))
            for name, val in (
                ("diff", diff),
                ("cond", kwargs.pop("cond", None)),
                ("uncond", kwargs.pop("uncond", None)),
                ("final", kwargs.pop("final", None)),
            )
        }
        bs = kwargs.pop("blend_strength", 1.0)
        dbs = kwargs.pop("difference_blend_strength", 1.0)
        fields = {f.name for f in dataclasses.fields(cls)} - {
            "target_mode", "diff", "cond", "uncond", "final", "wavelet",
            "blend_strength", "difference_blend_strength",
        }
        return cls(
            target_mode=target_mode,
            blend_strength=WCFGScheduledFloat.build(bs),
            difference_blend_strength=WCFGScheduledFloat.build(dbs),
            wavelet=WCFGWaveletSettings.build(**kwargs),
            **parts,
            **filter_dict(kwargs, fields),
        )


@dataclasses.dataclass(frozen=True)
class WCFGRules:
    rules: tuple = ()

    def __len__(self):
        return len(self.rules)

    def __getitem__(self, i):
        return self.rules[i]

    def __bool__(self):
        return bool(self.rules)

    @classmethod
    def build(cls, **params) -> "WCFGRules":
        params = dict(params)
        extra = params.pop("rules", ())
        first = WCFGRule.build(**params)
        return cls(rules=(first, *(WCFGRule.build(**p) for p in extra)))

    def match_index(self, sigma: float) -> int:
        """First rule whose window holds the host sigma, compared in float32
        as the JAX package compares its traced sigma; ``len(rules)`` = no
        match (the fallback)."""
        s = f32(sigma)
        for i, r in enumerate(self.rules):
            hi = math.inf if r.start_sigma < 0 else r.start_sigma
            if f32(r.end_sigma) <= s <= f32(hi):
                return i
        return len(self.rules)


# ---------------------------------------------------------------------------
# The CFG function (py/wavelet_cfg.py:631-842)
# ---------------------------------------------------------------------------


def _f32_tree(v):
    if isinstance(v, (list, tuple)):
        return type(v)(_f32_tree(i) for i in v)
    return v if isinstance(v, str) else float(f32(v))


def _emit_verbose_dump(rule, pcts, wcfg_blend, dbs, verbose_scales):
    """The reference's per-step rule dump (py/wavelet_cfg.py:225, 364-401),
    in the JAX package's lines: resolved schedule percentages, blend
    strengths and per-part yl/yh scales (parts in sorted order, as the JAX
    package's pytree hands them over), through
    :func:`sonar_tpu_torch.utils.profiling.verbose_writer`."""
    from ..utils.profiling import verbose_writer

    verbose_writer(
        "WCFG: rule "
        f"[{rule.start_sigma:g}, {rule.end_sigma:g}] "
        f"pct_sampling={float(pcts.pct_sampling):.4f} "
        f"pct_enabled={float(pcts.pct_enabled_sampling):.4f} "
        f"blend={float(wcfg_blend):.4f} "
        f"difference_blend={float(dbs):.4f}"
    )
    for name in sorted(verbose_scales):
        yl, yh = verbose_scales[name]
        verbose_writer(f"WCFG:   {name}: yl_scale={_f32_tree(yl)} yh_scales={_f32_tree(yh)}")


def basic_cfg(args: dict):
    """x − (uncond + (cond−uncond)·scale) (py/wavelet_cfg.py:656-660)."""
    x, scale = args["input"], args["cond_scale"]
    uncond, cond = args["uncond_denoised"], args["cond_denoised"]
    return x - (uncond + (cond - uncond) * scale)


def _eff_dtype(high_precision: bool, dtype):
    return torch.float64 if high_precision else torch.promote_types(dtype, torch.float32)


class WaveletCFG:
    """Drop-in CFG function: call with the ComfyUI-style args dict
    (input/sigma/cond/uncond/cond_denoised/uncond_denoised/cond_scale) plus
    ``model_sampling``, the optional step table ``sample_sigmas`` and the
    host sigma ``sigma_host``."""

    def __init__(self, *, rules: WCFGRules, existing_cfg: Callable | None = None,
                 operation_cond=None, operation_uncond=None,
                 operation_fallback_cfg=None, operation_wavelet_cfg=None,
                 operation_result=None):
        self.rules = rules
        self.fallback_cfg_function = (
            existing_cfg
            if existing_cfg is not None and (not rules or rules[0].fallback_existing)
            else basic_cfg
        )
        self.operation_cond = operation_cond
        self.operation_uncond = operation_uncond
        self.operation_fallback_cfg = operation_fallback_cfg
        self.operation_wavelet_cfg = operation_wavelet_cfg
        self.operation_result = operation_result

    @staticmethod
    def _maybe_op(t, mop, **kwargs):
        # plain (non-extended) LATENT_OPERATION callables take latent only,
        # like the reference's maybe_op (py/wavelet_cfg.py:663-675)
        if mop is None:
            return t
        if getattr(mop, "EXTENDED_LATENT_OPERATION", False):
            return mop(latent=t, **kwargs)
        return mop(latent=t)

    def _rule_branch(self, rule: WCFGRule, args: dict, ms, sample_sigmas, sigma_f: float):
        x = args["input"]
        sigma = torch.as_tensor(args["sigma"], device=x.device)
        pcts = WCFGPercentages.build(
            ms=ms, start_sigma=rule.start_sigma, end_sigma=rule.end_sigma,
            sigma=sigma_f, sigmas=sample_sigmas)
        blend_function = BLENDING_MODES[rule.blend_mode]
        wcfg_blend = rule.blend_strength.get_value(pcts)
        static_blend = rule.blend_strength.is_static

        # -- context (py/wavelet_cfg.py:677-727) --------------------------------
        if x.ndim == 3 and not rule.wavelet.use_1d_dwt:
            raise RuntimeError("Enable use_1d_dwt mode for 3D latents.")
        if x.ndim < 3:
            raise RuntimeError("Wavelet CFG can't handle latents with 2 or less dimensions.")
        sigma_b = sigma.reshape((-1,) + (1,) * (x.ndim - 1)) if sigma.ndim < x.ndim else sigma
        if rule.target_mode in ("noise", "noise_norm"):
            cond, uncond = args["cond"], args["uncond"]
            if rule.target_mode == "noise_norm":
                cond, uncond = cond / sigma_b, uncond / sigma_b
        else:
            cond, uncond = args["cond_denoised"], args["uncond_denoised"]
        op_kwargs = {"sigma": sigma, "cond": cond, "uncond": uncond,
                     "cond_scale": args.get("cond_scale"), "raw_args": args}
        cond = self._maybe_op(cond, self.operation_cond, **op_kwargs)
        uncond = self._maybe_op(uncond, self.operation_uncond, **op_kwargs)
        dt = _eff_dtype(rule.high_precision_mode, x.dtype)
        wavelet = rule.wavelet.make_wavelet()
        if rule.wavelet.use_1d_dwt:
            cond2 = cond.reshape(cond.shape[0], cond.shape[1], -1)
            uncond2 = uncond.reshape(cond2.shape)
        elif x.ndim > 4:
            cond2 = cond.reshape(cond.shape[0], -1, *cond.shape[-2:])
            uncond2 = uncond.reshape(cond2.shape)
        else:
            cond2, uncond2 = cond, uncond

        # -- wavelet cfg core (py/wavelet_cfg.py:749-791) -----------------------
        verbose_scales: dict = {}

        def _resolve(name, scales_range, yh):
            scales = scales_range.get_scales(pcts, yh)
            if rule.verbose:
                verbose_scales[name] = (scales.yl_scale, scales.yh_scales)
            return scales

        diff_blend = BLENDING_MODES[rule.difference_blend_mode]
        condw = wavelet.forward(cond2.to(dt))
        uncondw = wavelet.forward(uncond2.to(dt))
        if rule.cond is not None:
            condw = apply_wcfg_scales(_resolve("cond", rule.cond, condw[1]), *condw)
        if rule.uncond is not None:
            uncondw = apply_wcfg_scales(_resolve("uncond", rule.uncond, uncondw[1]), *uncondw)
        diffw = (condw[0] - uncondw[0], tuple(a - b for a, b in zip(condw[1], uncondw[1])))
        if rule.diff is not None:
            diffw = apply_wcfg_scales(_resolve("diff", rule.diff, diffw[1]), *diffw)
        dbs = rule.difference_blend_strength.get_value(pcts)
        resultw = (diff_blend(uncondw[0], diffw[0], dbs),
                   tuple(diff_blend(u, d, dbs) for u, d in zip(uncondw[1], diffw[1])))
        if rule.final is not None:
            resultw = apply_wcfg_scales(_resolve("final", rule.final, resultw[1]), *resultw)
        if rule.verbose:
            _emit_verbose_dump(rule, pcts, wcfg_blend, dbs, verbose_scales)
        result = wavelet.inverse(*resultw, out_shape=cond2.shape).to(x.dtype)

        # -- blend with the fallback CFG (py/wavelet_cfg.py:820-836) ------------
        need_fallback = rule.blend_mode != "lerp" or not static_blend or (
            static_blend and rule.blend_strength.value_start != 1.0)
        if need_fallback:
            normal = self._maybe_op(self.fallback_cfg_function(args),
                                    self.operation_fallback_cfg, **op_kwargs)
            if rule.target_mode == "denoised":
                normal = x - normal
            elif rule.target_mode == "noise_norm":
                normal = normal / sigma_b
            normal2 = normal.reshape(cond2.shape) if normal.shape != cond2.shape else normal
            result = blend_function(normal2, result, wcfg_blend)

        # -- process output (py/wavelet_cfg.py:729-747) -------------------------
        if rule.wavelet.use_1d_dwt:
            result = result[..., : cond2.shape[2]].reshape(x.shape)
        elif x.ndim > 4:
            result = result[..., : x.shape[-2], : x.shape[-1]].reshape(x.shape)
        else:
            result = result[tuple(slice(None, s) for s in x.shape)]
        if rule.target_mode == "denoised":
            result = x - result
        elif rule.target_mode == "noise_norm":
            result = result * sigma_b
        result = self._maybe_op(result, self.operation_wavelet_cfg, **op_kwargs)
        return self._maybe_op(result, self.operation_result, **op_kwargs)

    def __call__(self, args: dict):
        ms = fallback(args.get("model_sampling"), ContinuousEDM())
        if not self.rules:
            return self.fallback_cfg_function(args)
        sigma_f = host_sigma(args)
        idx = self.rules.match_index(sigma_f)
        if idx == len(self.rules):
            return self._maybe_op(
                self.fallback_cfg_function(args), self.operation_fallback_cfg,
                sigma=args["sigma"], cond=args["cond_denoised"],
                uncond=args["uncond_denoised"], raw_args=args)
        return self._rule_branch(self.rules[idx], args, ms, args.get("sample_sigmas"), sigma_f)
