"""Node parameter validation against the reference schemas (port of
``sonar_tpu.api.validate``).

The reference gives every node typed fields with defaults/min/max and hard
validation (py/nodes/base_inputtypes.py:9-263, base.py:50-171). The builder
API here enforces the same surface: unknown parameter names raise with the
valid list, enum violations raise, numeric range violations raise. The
tables live in :mod:`sonar_tpu_torch.api.schemas` (generated from the
reference schemas by ``python -m sonar_tpu_torch.api._gen_schemas``);
framework-defined enum domains (noise types, blend modes, ...) are resolved
against the port's live registries so extensions remain valid.

Per-node adaptations (ADAPT) document where this framework's surface
deliberately differs from the reference widget surface:

- ``extra``: additional accepted parameter names (framework features or
  aliases); ``"*"`` means the node forwards free-form config (yaml-style
  rule parameters) and unknown names are allowed.
- ``removed``: reference parameters that cannot be honored here, mapped to
  an actionable message (e.g. ``model`` → pass ``model_sampling=``).
"""

from __future__ import annotations

from typing import Any, Callable

from .schemas import SCHEMAS

# nodes registered under a framework-side name whose schema lives under the
# reference mapping name
ALIASES = {
    "SonarToComfyNOISE": "SONAR_CUSTOM_NOISE to NOISE",
}

_MODEL_MSG = (
    "this framework has no ComfyUI MODEL object; pass model_sampling= "
    "(a sonar_tpu_torch.cfg.model_sampling object) instead"
)

_SONAR_CONFIG_EXTRA = frozenset({
    "momentum_start_step", "momentum_end_step", "always_update_history",
    "momentum_mode", "custom_noise", "rand_init_noise_multiplier", "guidance",
    "blend_mode", "momentum_blend_mode", "history_blend_mode",
    "guidance_blend_mode", "init", "sonar_params", "noise_item", "extra_args",
    "seed", "eta", "s_noise",
})

ADAPT: dict[str, dict[str, Any]] = {
    "SamplerSonarEuler": {"extra": _SONAR_CONFIG_EXTRA},
    "SamplerSonarEulerA": {"extra": _SONAR_CONFIG_EXTRA},
    "SamplerSonarDPMPPSDE": {"extra": _SONAR_CONFIG_EXTRA},
    "SamplerConfigOverride": {"extra": {"noise_item"}},
    "SonarCustomNoise": {"extra": {"normalize"}},
    "SonarCustomNoiseAdv": {"extra": {"normalize"}},
    "SonarAdvancedCollatzNoise": {
        "extra": {"seed_custom_noise_opt", "mix_custom_noise_opt"}},
    "SonarAdvancedDistroNoise": {"extra": {"distro"}},
    "SonarWaveletNoise": {"extra": {"custom_noise_opt", "update_blend_function",
                                    "min_height", "min_width"}},
    "SonarWaveletFilteredNoise": {"extra": "*"},
    "SonarScatternetFilteredNoise": {"extra": {"wavelet_backend"}},
    "SonarScheduledNoise": {"extra": {"model_sampling"},
                            "removed": {"model": _MODEL_MSG}},
    "SonarWaveletCFG": {"extra": "*", "removed": {"model": _MODEL_MSG}},
    "FreeUExtreme": {"extra": {"model_sampling", "model_channels"},
                     "removed": {"model": _MODEL_MSG + " plus model_channels="}},
    "NoisyLatentLike": {
        "extra": {"model_sampling", "mul_by_sigmas", "latent_scale_factor"}},
    "SonarNoiseImage": {"extra": {"strict_reference_compat"}},
    "SONAR_CUSTOM_NOISE to NOISE": {"extra": {"sonar_custom_noise"}},
    "KRestartSamplerCustomNoise": {
        "extra": {"inner_sampler", "s_noise", "custom_noise",
                  "sonar_custom_noise"}},
    "RestartSamplerCustomNoise": {
        "extra": {"inner_sampler", "s_noise", "seed", "segments",
                  "custom_noise", "sonar_custom_noise"}},
    "SonarApplyLatentOperationCFG": {
        "extra": {"operation", "operations", "model_sampling"}},
    "SonarLatentOperationSetSeed": {"extra": {"op"}},
    "SonarPreviewFilter": {"extra": {"size"}},
    "SonarPowerFilter": {"extra": {"rel_bw", "sonar_power_filter_opt"}},
    "SonarPowerNoise": {
        "extra": {"oversample", "rel_bw", "scale", "filter_norm_factor",
                  "power_filter"}},
    "SonarPowerFilterNoise": {"extra": {"oversample", "rel_bw", "scale",
                                        "time_brownian"}},
    "SonarBlehOpsNoise": {"extra": {"reference"}},
}


def _domain_noise_type() -> set:
    from ..noise.presets import noise_type_names

    return set(noise_type_names(None))


def _domain_blend() -> set:
    from ..core.blend import BLENDING_MODES

    # "simple_add" is a widget-level insert mode (raw sum, not a blend
    # function — py/nodes/integrations.py:29), always accepted.
    return set(BLENDING_MODES) | {"simple_add"}


def _domain_scale() -> set:
    from ..ops.resample import UPSCALE_METHODS

    return set(UPSCALE_METHODS)


def _domain_distro() -> set:
    from ..noise.distro import DISTRO_PARAMS

    return set(DISTRO_PARAMS)


def _domain_quantile_strategy() -> set:
    from ..core.normalize import QUANTILE_HANDLERS

    return set(QUANTILE_HANDLERS)


def _domain_ffilter() -> set:
    from ..noise.blendfilter import FILTER_PRESETS

    return set(FILTER_PRESETS)


def _domain_enhance() -> set:
    from ..noise.blendfilter import ENHANCE_HANDLERS

    # the JAX package reads its ``_ENHANCE_MODES = ("none", *ENHANCE_HANDLERS)``
    return {"none", *ENHANCE_HANDLERS}


DOMAINS: dict[str, Callable[[], set] | None] = {
    "noise_type": _domain_noise_type,
    "blend": _domain_blend,
    "scale": _domain_scale,
    "distro": _domain_distro,
    "quantile_strategy": _domain_quantile_strategy,
    "ffilter": _domain_ffilter,
    "enhance": _domain_enhance,
    "any_str": None,
}

_TRI = {"default", "forced", "disabled"}


def _err(node: str, field: str, msg: str):
    raise ValueError(f"{node}: parameter {field!r} {msg}")


def _check_value(node: str, field: str, spec: dict, value) -> None:
    kind = spec["t"]
    if value is None:
        return  # None = "use the default" / unattached optional input
    if kind == "x" or kind == "s":
        return  # object links / free-form strings (mini-languages, yaml)
    if kind == "f":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            _err(node, field, f"expects a float, got {type(value).__name__}")
        lo, hi = spec.get("lo"), spec.get("hi")
        if lo is not None and value < lo or hi is not None and value > hi:
            _err(node, field, f"= {value} out of range [{lo}, {hi}]")
    elif kind == "i":
        if isinstance(value, bool) or not isinstance(value, int):
            _err(node, field, f"expects an int, got {type(value).__name__}")
        lo, hi = spec.get("lo"), spec.get("hi")
        if lo is not None and value < lo or hi is not None and value > hi:
            _err(node, field, f"= {value} out of range [{lo}, {hi}]")
    elif kind == "b":
        if not isinstance(value, bool):
            _err(node, field, f"expects a bool, got {type(value).__name__}")
    elif kind == "tri":
        if not (isinstance(value, bool) or value in _TRI):
            _err(node, field,
                 f"= {value!r} invalid; expects one of {sorted(_TRI)} "
                 "(or True/False/None)")
    elif kind == "enum":
        opts = spec["opts"]
        # widgets that were historically booleans (enable/disable) accept bools
        if isinstance(value, bool) and any(
            o in ("enable", "disable", "enabled", "disabled") for o in opts
        ):
            return
        if str(value) not in opts:
            _err(node, field, f"= {value!r} invalid; options: {', '.join(opts)}")
    elif kind == "dyn":
        dom_fn = DOMAINS[spec["dom"]]
        if spec["dom"] == "ffilter" and isinstance(value, (list, tuple)):
            return  # explicit gain-curve list
        if not isinstance(value, str):
            _err(node, field, f"expects a string, got {type(value).__name__}")
        if dom_fn is None:
            return
        domain = dom_fn() | set(spec.get("extras", ()))
        if value not in domain:
            _err(node, field,
                 f"= {value!r} invalid; options: {', '.join(sorted(domain))}")


def validate_params(node_name: str, params: dict) -> dict:
    """Validate ``params`` for ``node_name`` against the reference schema.

    Returns the params unchanged on success; raises ValueError on unknown
    names, removed parameters, enum violations, or numeric range violations.
    """
    schema = SCHEMAS.get(ALIASES.get(node_name, node_name))
    if schema is None:
        return params
    adapt = ADAPT.get(ALIASES.get(node_name, node_name), {})
    extra = adapt.get("extra", ())
    free_form = extra == "*"
    extra_ok = set() if free_form else set(extra)
    removed = adapt.get("removed", {})
    for key, value in params.items():
        if key in removed:
            _err(node_name, key, f"is not supported: {removed[key]}")
        spec = schema.get(key)
        if spec is None:
            if free_form or key in extra_ok:
                continue
            valid = ", ".join(sorted(set(schema) | extra_ok))
            _err(node_name, key, f"is unknown; valid: {valid}")
        else:
            _check_value(node_name, key, spec, value)
    return params
