"""Node-level API parity (port of ``sonar_tpu.api.nodes``): every reference
node name maps to a builder with the same parameter surface (reference:
py/nodes/*, 48 entries in NODE_CLASS_MAPPINGS), building the port's classes.

This is the workflow-porting layer: a ComfyUI-sonar graph's node names and
widget values translate 1:1 into ``build(node_name, **params)`` calls. The
ComfyUI-specific inputs are adapted:

- ``model`` inputs (used only for ``model_sampling``) become a
  ``model_sampling`` object (:mod:`sonar_tpu_torch.cfg.model_sampling`);
- chain semantics match py/nodes/base.py:225-239: the upstream chain is
  cloned, the new item appended unless ``factor == 0``, then rescaled;
- tri-state normalize widgets accept "default"/"forced"/"disabled"
  (py/nodes/noise_filters.py:137-139) as well as None/True/False.

Builders preserve the reference node quirks (SURVEY §7.3): the composite
normalize_src/dst swap, the NormalizeToScale dims reuse, the NoiseImage
channel-map B/G swap.

Tensor inputs (latents, images, masks) stay on their device; a numpy input
that a builder turns into a tensor goes to the card (``default_device``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..cfg import (
    FreeUExtremeConfig,
    SonarLatentOperation,
    SonarLatentOperationAdvanced,
    SonarLatentOperationNoise,
    SonarLatentOperationQuantileFilter,
    WaveletCFG,
    WCFGRules,
)
from ..core.blend import BLENDING_MODES
from ..core.normalize import scale_noise
from ..noise import (
    BlendedNoise,
    ChannelNoise,
    CompositeNoise,
    CustomNoiseParametersNoise,
    GuidedNoise,
    LatentOperationFilteredNoise,
    ModulatedNoise,
    NoiseChain,
    NormalizeToScaleNoise,
    PatternBreakNoise,
    PerDimNoise,
    QuantileFilteredNoise,
    RandomNoise,
    RepeatedNoise,
    ResizedNoise,
    RippleFilteredNoise,
    ScheduledNoise,
    ShuffledNoise,
    TypedNoiseItem,
)
from ..noise.collatz import CollatzGenerator
from ..noise.distro import DistroGenerator
from ..noise.generators import (
    HighresPyramidGenerator,
    OneFGenerator,
    PowerLawGenerator,
    PyramidGenerator,
    PyramidOldGenerator,
)
from ..noise.power import PowerFilter, PowerFilterNoiseItem, PowerNoiseItem
from ..noise.scatternet import ScatternetFilteredNoise
from ..noise.voronoi import VoronoiGenerator
from ..noise.wavelet import WaveletFilteredNoise, WaveletGenerator
from ..samplers.momentum import GuidanceConfig, SonarConfig
from ..utils.misc import default_device
from .config import safe_load_yaml
from .functions import (
    get_sampler,
    noise_image,
    noisy_latent_like,
    sampler_config_override,
)

NODES: dict[str, Callable] = {}


def register_node(name: str):
    def deco(fn):
        NODES[name] = fn
        fn.__name__ = f"node_{name}"
        return fn

    return deco


def build(node_name: str, *, _validate: bool = True, **params):
    """Build a framework object from a reference node name + widget values.

    Parameters are validated against the reference node schemas
    (sonar_tpu_torch.api.schemas, generated from py/nodes/base_inputtypes.py
    surfaces): unknown names, enum violations, and out-of-range numerics
    raise ValueError. Pass ``_validate=False`` to bypass (power users only).
    """
    try:
        fn = NODES[node_name]
    except KeyError:
        valid = ", ".join(sorted(NODES))
        raise ValueError(f"Unknown node {node_name!r}; valid: {valid}") from None
    if _validate:
        from .validate import validate_params

        params = validate_params(node_name, params)
    return fn(**params)


def tristate(val):
    """'default'/'forced'/'disabled' → None/True/False (py/nodes/noise_filters.py:137)."""
    if val is None or isinstance(val, bool):
        return val
    return None if val == "default" else val == "forced"


def _chain(item, factor, rescale=0.0, sonar_custom_noise_opt=None):
    """py/nodes/base.py:225-239."""
    chain = (
        sonar_custom_noise_opt.clone()
        if sonar_custom_noise_opt is not None
        else NoiseChain()
    )
    if not isinstance(chain, NoiseChain):
        chain = NoiseChain([chain])
    if factor != 0 and item is not None:
        chain.add(item)
    return chain if rescale == 0 else chain.rescaled(rescale)


def _as_tensor(x) -> torch.Tensor:
    """A tensor stays on its device. Anything else becomes a tensor on the
    card (``default_device``); float64 becomes float32, as ``jnp.asarray``
    makes it with 64-bit mode off."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x))
    return (t.float() if t.dtype == torch.float64 else t).to(default_device())


def _percent_to_sigma(model_sampling, percent: float) -> float:
    return model_sampling.percent_to_sigma(percent)


# -- base ------------------------------------------------------------------------


@register_node("SonarCustomNoise")
def sonar_custom_noise(*, factor=1.0, rescale=0.0, noise_type="gaussian",
                       sonar_custom_noise_opt=None, **kwargs):
    item = TypedNoiseItem(factor, noise_type=noise_type, **kwargs)
    return _chain(item, factor, rescale, sonar_custom_noise_opt)


@register_node("SonarCustomNoiseAdv")
def sonar_custom_noise_adv(*, factor=1.0, rescale=0.0, noise_type="gaussian",
                           normalize=None, yaml_parameters=None,
                           sonar_custom_noise_opt=None, **kwargs):
    extra = dict(kwargs)
    if yaml_parameters:
        parsed = safe_load_yaml(yaml_parameters)
        if parsed is not None:
            if not isinstance(parsed, dict):
                raise ValueError("yaml_parameters must parse to a dict")
            extra |= parsed
    item = TypedNoiseItem(factor, noise_type=noise_type,
                          normalize=tristate(normalize), **extra)
    return _chain(item, factor, rescale, sonar_custom_noise_opt)


# -- momentum samplers (py/nodes/momentum_samplers.py) ----------------------------


@register_node("SonarGuidanceConfig")
def sonar_guidance_config(*, guidance_type="linear", factor=0.01, start_step=1,
                          end_step=9999, latent=None):
    return GuidanceConfig(guidance_type=guidance_type, factor=factor,
                          start_step=start_step, end_step=end_step, latent=latent)


def _sonar_config(kwargs) -> SonarConfig:
    fields = {
        "momentum", "momentum_hist", "direction", "momentum_start_step",
        "momentum_end_step", "always_update_history", "momentum_mode", "init",
        "noise_type", "custom_noise", "rand_init_noise_type",
        "rand_init_noise_multiplier", "guidance", "blend_mode",
        "momentum_blend_mode", "history_blend_mode", "guidance_blend_mode",
    }
    cfg_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in fields}
    if "momentum_init" in kwargs:
        cfg_kwargs["init"] = kwargs.pop("momentum_init")
    if "guidance_cfg_opt" in kwargs:
        cfg_kwargs["guidance"] = kwargs.pop("guidance_cfg_opt")
    # the node's SONAR_CUSTOM_NOISE input is the config's custom noise, as in
    # the reference (SURVEY: custom_noise > noise sampler > noise_type). The
    # JAX package's builder lets sampler_config_override drop it, and its
    # sampler then draws the noise_type default.
    if kwargs.get("custom_noise_opt") is not None:
        cfg_kwargs["custom_noise"] = kwargs.pop("custom_noise_opt")
    kwargs.pop("custom_noise_opt", None)
    return SonarConfig(**cfg_kwargs)


@register_node("SamplerSonarEuler")
def sampler_sonar_euler(**kwargs):
    cfg = _sonar_config(kwargs)
    return sampler_config_override("sonar_euler", sonar_config=cfg, **kwargs)


@register_node("SamplerSonarEulerA")
def sampler_sonar_euler_a(**kwargs):
    cfg = _sonar_config(kwargs)
    return sampler_config_override("sonar_euler_ancestral", sonar_config=cfg, **kwargs)


@register_node("SamplerSonarDPMPPSDE")
def sampler_sonar_dpmpp_sde(**kwargs):
    cfg = _sonar_config(kwargs)
    return sampler_config_override("sonar_dpmpp_sde", sonar_config=cfg, **kwargs)


@register_node("SamplerConfigOverride")
def node_sampler_config_override(*, sampler, yaml_parameters=None, **kwargs):
    kwargs.pop("cpu_noise", None)  # the latent's device picks placement
    if yaml_parameters:
        parsed = safe_load_yaml(yaml_parameters)
        if parsed is not None:
            if not isinstance(parsed, dict):
                raise ValueError("yaml_parameters must parse to a dict")
            kwargs |= parsed
    noise_type = kwargs.pop("noise_type", "DEFAULT")
    custom = kwargs.pop("custom_noise_opt", None)
    if custom is not None:
        kwargs.setdefault("noise_item", custom)
    elif noise_type and noise_type != "DEFAULT":
        from ..noise.presets import get_noise_item

        kwargs.setdefault("noise_item", get_noise_item(noise_type))
    return sampler_config_override(sampler, **kwargs)


# -- advanced noise types (py/nodes/noise_types.py) -------------------------------


@register_node("SonarAdvancedPyramidNoise")
def adv_pyramid(*, factor=1.0, rescale=0.0, variant="highres_pyramid",
                sonar_custom_noise_opt=None, **kwargs):
    cls = {"pyramid": PyramidGenerator, "pyramid_old": PyramidOldGenerator,
           "highres_pyramid": HighresPyramidGenerator}[variant]
    # The port departs from the JAX package only where its draw fails (the
    # reference's source is not in the repository to say what the widgets'
    # defaults mean): upscale_mode "default", which no resize knows, is the
    # variant's own mode, and so is iterations -1 for highres_pyramid, whose
    # ladder cannot be drawn at -1. pyramid and pyramid_old draw no level at
    # -1 (the base alone; zeros for pyramid_old), as the JAX package's do,
    # and a discount is taken as given.
    if str(kwargs.get("upscale_mode")).lower() == "default":
        del kwargs["upscale_mode"]
    if variant == "highres_pyramid" and kwargs.get("iterations", 0) < 0:
        del kwargs["iterations"]
    return _chain(cls(factor, **kwargs), factor, rescale, sonar_custom_noise_opt)


@register_node("SonarAdvanced1fNoise")
def adv_onef(*, factor=1.0, rescale=0.0, sonar_custom_noise_opt=None, **kwargs):
    return _chain(OneFGenerator(factor, **kwargs), factor, rescale,
                  sonar_custom_noise_opt)


# dtype widgets by name. "float64" is float32: the JAX package runs with
# jax_enable_x64 off, so its float64 draw is float32, and the kernels (B1-B3)
# have no double instantiation. jnp takes a dtype's name where torch does not.
_DTYPES = {"default": None, "float32": torch.float32, "float64": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16}

# "none", "non-batch" (the widget's default) and "spatial" are the reference
# widget's names; the JAX package's map lacks them and hands the name itself
# to the generator, whose draw then fails
_DIV_MAX_DIMS_MAP = {
    "global": None, "all": (-3, -2, -1), "batch": 0, "channel": 1,
    "height": -2, "width": -1, "height_width": (-2, -1),
    "none": None, "non-batch": (-3, -2, -1), "spatial": (-2, -1),
}


@register_node("SonarAdvancedPowerLawNoise")
def adv_powerlaw(*, factor=1.0, rescale=0.0, div_max_dims="global",
                 sonar_custom_noise_opt=None, **kwargs):
    dims = _DIV_MAX_DIMS_MAP.get(div_max_dims, div_max_dims)
    if isinstance(dims, int):
        dims = (dims,)
    return _chain(PowerLawGenerator(factor, div_max_dims=dims, **kwargs),
                  factor, rescale, sonar_custom_noise_opt)


@register_node("SonarAdvancedCollatzNoise")
def adv_collatz(*, factor=1.0, rescale=0.0, sonar_custom_noise_opt=None,
                seed_custom_noise=None, mix_custom_noise=None,
                seed_custom_noise_opt=None, mix_custom_noise_opt=None, **kwargs):
    # reference optional input names are seed_custom_noise / mix_custom_noise
    # (py/nodes/noise_types.py); the *_opt forms are kept as aliases.
    seed_custom_noise_opt = seed_custom_noise_opt or seed_custom_noise
    mix_custom_noise_opt = mix_custom_noise_opt or mix_custom_noise
    if isinstance(kwargs.get("dims"), str):
        kwargs["dims"] = tuple(int(v) for v in kwargs["dims"].split(","))
    if isinstance(kwargs.get("noise_dtype"), str):
        kwargs["noise_dtype"] = _DTYPES[kwargs["noise_dtype"]]
    if isinstance(kwargs.get("chain_length"), str):
        kwargs["chain_length"] = tuple(
            int(v) for v in kwargs["chain_length"].split(","))
    return _chain(
        CollatzGenerator(factor, seed_noise_sampler=seed_custom_noise_opt,
                         mix_noise_sampler=mix_custom_noise_opt, **kwargs),
        factor, rescale, sonar_custom_noise_opt)


# quantile_norm_mode → (quantile_norm_dim, quantile_norm_flatten), exactly the
# reference widget mapping (py/nodes/noise_types.py:454-467; unknown → (1, True)).
_QNORM_MODE_MAP = {
    "global": (None, True), "batch": (0, True), "channel": (1, True),
    "batch_row": (2, True), "batch_col": (3, True),
    "nonflat_row": (2, False), "nonflat_col": (3, False),
}


@register_node("SonarAdvancedDistroNoise")
def adv_distro(*, factor=1.0, rescale=0.0, distro=None, distribution="normal",
               quantile_norm_mode="batch", result_index="-1",
               sonar_custom_noise_opt=None, **kwargs):
    normdim, normflat = _QNORM_MODE_MAP.get(quantile_norm_mode, (1, True))
    if isinstance(result_index, str):
        result_index = tuple(int(v) for v in result_index.split())
    return _chain(
        DistroGenerator(factor, distro=distro if distro is not None else distribution,
                        quantile_norm_dim=normdim, quantile_norm_flatten=normflat,
                        result_index=result_index, **kwargs),
        factor, rescale, sonar_custom_noise_opt)


@register_node("SonarWaveletNoise")
def wavelet_noise(*, factor=1.0, rescale=0.0, sonar_custom_noise_opt=None,
                  custom_noise_opt=None, custom_noise=None,
                  update_blend_mode=None, **kwargs):
    if update_blend_mode is not None:
        kwargs.setdefault("update_blend_function", BLENDING_MODES[update_blend_mode])
    child = custom_noise_opt if custom_noise_opt is not None else custom_noise
    return _chain(WaveletGenerator(factor, noise_sampler=child, **kwargs),
                  factor, rescale, sonar_custom_noise_opt)


@register_node("SonarAdvancedVoronoiNoise")
def adv_voronoi(*, factor=1.0, rescale=0.0, sonar_custom_noise_opt=None,
                custom_noise_opt=None, **kwargs):
    # the reference widgets are comma-separated strings (n_points "256" by
    # default); the JAX package wraps a lone mode name but hands n_points'
    # string to the generator, whose draw then fails
    for key in ("distance_mode", "result_mode"):
        if isinstance(kwargs.get(key), str):
            kwargs[key] = tuple(v.strip() for v in kwargs[key].split(",") if v.strip())
    if isinstance(kwargs.get("n_points"), str):
        kwargs["n_points"] = tuple(int(v) for v in kwargs["n_points"].split(",") if v.strip())
    elif isinstance(kwargs.get("n_points"), (int, float)):
        kwargs["n_points"] = (int(kwargs["n_points"]),)
    return _chain(
        VoronoiGenerator(factor, noise_sampler_factory=custom_noise_opt, **kwargs),
        factor, rescale, sonar_custom_noise_opt)


# -- noise filters (py/nodes/noise_filters.py) ------------------------------------


@register_node("SonarModulatedNoise")
def modulated(*, factor=1.0, sonar_custom_noise, modulation_type="none", dims=3,
              strength=2.0, normalize_result=None, normalize_noise=None,
              normalize_ref=True, ref_latent_opt=None):
    return _chain(
        ModulatedNoise(factor, noise=sonar_custom_noise.clone(),
                       modulation_type=modulation_type, modulation_dims=dims,
                       modulation_strength=strength,
                       normalize_result=tristate(normalize_result),
                       normalize_noise=tristate(normalize_noise),
                       normalize_ref=tristate(normalize_ref),
                       ref_latent_opt=ref_latent_opt),
        factor)


@register_node("SonarRepeatedNoise")
def repeated(*, factor=1.0, sonar_custom_noise, repeat_length=8, max_recycle=1000,
             normalize=None, permute="enabled"):
    if isinstance(permute, bool):  # old widget form
        permute = "enabled" if permute else "disabled"
    return _chain(
        RepeatedNoise(factor, noise=sonar_custom_noise.clone(),
                      repeat_length=repeat_length, max_recycle=max_recycle,
                      normalize=tristate(normalize), permute=permute),
        factor)


@register_node("SonarScheduledNoise")
def scheduled(*, factor=1.0, model_sampling, sonar_custom_noise, start_percent=0.0,
              end_percent=1.0, normalize=None, fallback_sonar_custom_noise=None):
    # percent → sigma via model_sampling (py/nodes/noise_filters.py:188-198)
    return _chain(
        ScheduledNoise(
            factor, noise=sonar_custom_noise.clone(),
            start_sigma=_percent_to_sigma(model_sampling, start_percent),
            end_sigma=_percent_to_sigma(model_sampling, end_percent),
            normalize=tristate(normalize),
            fallback_noise=None if fallback_sonar_custom_noise is None
            else fallback_sonar_custom_noise.clone()),
        factor)


@register_node("SonarCompositeNoise")
def composite(*, factor=1.0, sonar_custom_noise_dst, sonar_custom_noise_src, mask,
              normalize_src=None, normalize_dst=None, normalize_result=None):
    # reference quirk: src/dst normalize swap (py/nodes/noise_filters.py:246-247)
    return _chain(
        CompositeNoise(factor, dst_noise=sonar_custom_noise_dst.clone(),
                       src_noise=sonar_custom_noise_src.clone(), mask=mask,
                       normalize_dst=tristate(normalize_src),
                       normalize_src=tristate(normalize_dst),
                       normalize_result=tristate(normalize_result)),
        factor)


@register_node("SonarGuidedNoise")
def guided(*, factor=1.0, latent, normalize_noise=None, normalize_result=None,
           normalize_ref=True, method="euler", guidance_factor=0.5,
           sonar_custom_noise=None):
    ref = scale_noise(_as_tensor(latent), normalized=bool(tristate(normalize_ref)
                                                           in (True, None)))
    return _chain(
        GuidedNoise(factor, ref_latent=ref, guidance_factor=guidance_factor,
                    method=method,
                    noise=None if sonar_custom_noise is None
                    else sonar_custom_noise.clone(),
                    normalize_noise=tristate(normalize_noise),
                    normalize_result=tristate(normalize_result)),
        factor)


@register_node("SonarRandomNoise")
def random_noise(*, factor=1.0, sonar_custom_noise, mix_count=1, normalize=None):
    return _chain(
        RandomNoise(factor, noise=sonar_custom_noise.clone(), mix_count=mix_count,
                    normalize=tristate(normalize)),
        factor)


@register_node("SonarChannelNoise")
def channel(*, factor=1.0, sonar_custom_noise, insufficient_channels_mode="wrap",
            normalize=None, mix_count=1):
    # ``mix_count`` is declared in the reference node schema
    # (py/nodes/noise_filters.py:370-375) but its go() never accepts or
    # forwards it (noise_filters.py:385-398) — accepted here for workflow
    # compatibility and ignored, matching the (buggy) reference surface.
    del mix_count
    return _chain(
        ChannelNoise(factor, noise=sonar_custom_noise.clone(),
                     insufficient_channels_mode=insufficient_channels_mode,
                     normalize=tristate(normalize)),
        factor)


@register_node("SonarBlendedNoise")
def blended(*, factor=1.0, rescale=0.0, sonar_custom_noise_opt=None, normalize=None,
            noise_2_percent=0.5, custom_noise_1=None, custom_noise_2=None,
            custom_noise_mask=None, blend_mode="lerp"):
    if blend_mode not in BLENDING_MODES:
        raise ValueError("Unknown blend mode")
    item = BlendedNoise(factor, blend_function=BLENDING_MODES[blend_mode],
                        normalize=tristate(normalize),
                        noise_2_percent=noise_2_percent,
                        custom_noise_1=custom_noise_1,
                        custom_noise_2=custom_noise_2,
                        custom_noise_mask=custom_noise_mask)
    return _chain(item, factor, rescale, sonar_custom_noise_opt)


@register_node("SonarResizedNoise")
def resized(*, factor=1.0, width=1152, height=1152, custom_noise,
            downscale_strategy="crop", initial_reference="prefer_crop",
            crop_offset_horizontal=0, crop_offset_vertical=0, crop_mode="center",
            upscale_mode="bilinear", downscale_mode="bilinear", normalize=None):
    # fixed absolute mode with 8x spatial compression (noise_filters.py:460-567)
    return _chain(
        ResizedNoise(factor, custom_noise=custom_noise.clone(), width=width,
                     height=height, spatial_mode="absolute", spatial_compression=8,
                     downscale_strategy=downscale_strategy,
                     initial_reference=initial_reference,
                     crop_offset_horizontal=crop_offset_horizontal,
                     crop_offset_vertical=crop_offset_vertical,
                     crop_mode=crop_mode, upscale_mode=upscale_mode,
                     downscale_mode=downscale_mode, normalize=tristate(normalize)),
        factor)


@register_node("SonarResizedNoiseAdv")
def resized_adv(*, factor=1.0, custom_noise, normalize=None, **kwargs):
    return _chain(
        ResizedNoise(factor, custom_noise=custom_noise.clone(),
                     normalize=tristate(normalize), **kwargs),
        factor)


_QUANTILE_DIM_MAP = {"global": None, "0": 0, "1": 1, "2": 2, "3": 3, "4": 4}


@register_node("SonarQuantileFilteredNoise")
def quantile_filtered(*, factor=1.0, custom_noise, quantile=0.85, dim="1",
                      flatten=True, norm_factor=1.0, norm_power=0.5,
                      strategy="clamp", normalize=None, normalize_noise=False):
    return _chain(
        QuantileFilteredNoise(factor, noise=custom_noise.clone(), quantile=quantile,
                              norm_dim=_QUANTILE_DIM_MAP.get(str(dim), 1),
                              norm_flatten=flatten, norm_fac=norm_factor,
                              norm_pow=norm_power, strategy=strategy,
                              normalize=tristate(normalize),
                              normalize_noise=bool(tristate(normalize_noise))),
        factor)


@register_node("SonarShuffledNoise")
def shuffled(*, factor=1.0, custom_noise, dims=(-1,), percentages=(1.0,),
             fork_rng=True, no_identity=False, normalize=None):
    if isinstance(dims, str):
        dims = tuple(int(v) for v in dims.split(","))
    if isinstance(percentages, str):
        percentages = tuple(float(v) for v in percentages.split(","))
    return _chain(
        ShuffledNoise(factor, noise=custom_noise.clone(), dims=dims,
                      percentages=percentages, fork_rng=fork_rng,
                      no_identity=no_identity, normalize=tristate(normalize)),
        factor)


@register_node("SonarPatternBreakNoise")
def pattern_break_node(*, factor=1.0, custom_noise, blend_mode="lerp",
                       detail_level=0.0, percentage=1.0, restore_scale=True):
    return _chain(
        PatternBreakNoise(factor, noise=custom_noise.clone(), blend_mode=blend_mode,
                          detail_level=detail_level, percentage=percentage,
                          restore_scale=restore_scale),
        factor)


@register_node("SonarWaveletFilteredNoise")
def wavelet_filtered(*, factor=1.0, custom_noise=None, custom_noise_high=None,
                     normalize=None, normalize_noise=False, yaml_parameters=None,
                     **kwargs):
    if yaml_parameters:
        parsed = safe_load_yaml(yaml_parameters)
        if parsed:
            kwargs |= parsed
    return _chain(
        WaveletFilteredNoise(
            factor,
            noise=None if custom_noise is None else custom_noise.clone(),
            noise_high=None if custom_noise_high is None
            else custom_noise_high.clone(),
            normalize=tristate(normalize),
            normalize_noise=bool(tristate(normalize_noise)), **kwargs),
        factor)


@register_node("SonarScatternetFilteredNoise")
def scatternet_filtered(*, factor=1.0, custom_noise=None, normalize=None,
                        normalize_noise=False, **kwargs):
    return _chain(
        ScatternetFilteredNoise(
            factor,
            noise=None if custom_noise is None else custom_noise.clone(),
            normalize=tristate(normalize),
            normalize_noise=bool(tristate(normalize_noise)), **kwargs),
        factor)


@register_node("SonarRippleFilteredNoise")
def ripple_filtered(*, factor=1.0, rescale=0.0, custom_noise,
                    sonar_custom_noise_opt=None, normalize=None,
                    normalize_noise=False, **kwargs):
    return _chain(
        RippleFilteredNoise(factor, noise=custom_noise.clone(),
                            normalize=tristate(normalize),
                            normalize_noise=bool(tristate(normalize_noise)),
                            **kwargs),
        factor, rescale, sonar_custom_noise_opt)


@register_node("SonarNormalizeNoiseToScale")
def normalize_to_scale_node(*, factor=1.0, rescale=0.0, custom_noise,
                            sonar_custom_noise_opt=None, dims="-3, -2, -1",
                            std_dims="-3, -2, -1", mean_dims="-3, -2, -1",
                            normalize=None, normalize_noise=False, **kwargs):
    if isinstance(dims, str):
        dims = () if not dims.strip() else tuple(int(i) for i in dims.split(","))
    # reference quirk (py/nodes/noise_filters.py:1267-1275): std_dims and
    # mean_dims gate on their OWN emptiness but always split `dims` — their
    # parsed content can never differ from dims.
    def _quirk(v):
        empty = (v is None or v == ()
                 or (isinstance(v, str) and not v.strip()))
        return None if empty else (dims or None)

    return _chain(
        NormalizeToScaleNoise(factor, noise=custom_noise.clone(), dims=dims,
                              std_dims=_quirk(std_dims),
                              mean_dims=_quirk(mean_dims),
                              normalize=tristate(normalize),
                              normalize_noise=bool(tristate(normalize_noise)),
                              **kwargs),
        factor, rescale, sonar_custom_noise_opt)


@register_node("SonarPerDimNoise")
def per_dim(*, factor=1.0, rescale=0.0, custom_noise, sonar_custom_noise_opt=None,
            dim=0, offset=0, chunk_size=1, shrink_dim=False, normalize=None,
            normalize_noise=False):
    return _chain(
        PerDimNoise(factor, noise=custom_noise.clone(), dim=dim, offset=offset,
                    chunk_size=chunk_size, shrink_dim=shrink_dim,
                    normalize=tristate(normalize),
                    normalize_noise=bool(tristate(normalize_noise))),
        factor, rescale, sonar_custom_noise_opt)


@register_node("SonarLatentOperationFilteredNoise")
def latent_op_filtered(*, factor=1.0, custom_noise, normalize=None,
                       normalize_noise=False, **ops):
    operations = tuple(
        op for k, op in sorted(ops.items()) if k.startswith("operation") and op
    )
    return _chain(
        LatentOperationFilteredNoise(factor, noise=custom_noise.clone(),
                                     operations=operations,
                                     normalize=tristate(normalize),
                                     normalize_noise=bool(tristate(normalize_noise))),
        factor)


@register_node("SonarCustomNoiseParameters")
def custom_params(*, factor=1.0, custom_noise, normalize=None, **kwargs):
    if isinstance(kwargs.get("override_dtype"), str):
        kwargs["override_dtype"] = _DTYPES.get(kwargs["override_dtype"])
    return _chain(
        CustomNoiseParametersNoise(factor, noise=custom_noise.clone(),
                                   normalize=tristate(normalize), **kwargs),
        factor)


# -- power noise (py/nodes/powernoise.py) ----------------------------------------


@register_node("SonarPowerFilter")
def power_filter(*, sonar_power_filter_opt=None, power_filter_opt=None,
                 compose_mode="max", **kwargs):
    # the reference's optional chain input is named power_filter_opt
    # (py/nodes/powernoise.py); sonar_power_filter_opt kept as an alias.
    compose_with = (sonar_power_filter_opt if sonar_power_filter_opt is not None
                    else power_filter_opt)
    if "blur" in kwargs:  # widget name for rel_bw (py/nodes/powernoise.py:798-813)
        kwargs.setdefault("rel_bw", kwargs.pop("blur"))
    return PowerFilter(compose_with=compose_with,
                       compose_mode=compose_mode, **kwargs)


@register_node("SonarPowerNoise")
def power_noise(*, factor=1.0, rescale=0.0, sonar_custom_noise_opt=None, **kwargs):
    kwargs.pop("preview", None)
    return _chain(PowerNoiseItem(factor, **kwargs), factor, rescale,
                  sonar_custom_noise_opt)


@register_node("SonarPowerFilterNoise")
def power_filter_noise(*, factor=1.0, rescale=0.0, sonar_custom_noise,
                       sonar_power_filter=None, sonar_custom_noise_opt=None,
                       normalize_noise=None, normalize_result=None, **kwargs):
    kwargs.pop("preview", None)
    return _chain(
        PowerFilterNoiseItem(factor, noise=sonar_custom_noise.clone(),
                             power_filter=sonar_power_filter,
                             normalize_noise=tristate(normalize_noise),
                             normalize_result=tristate(normalize_result), **kwargs),
        factor, rescale, sonar_custom_noise_opt)


@register_node("SonarPreviewFilter")
def preview_filter(*, sonar_power_filter, size=None, preview_size="128x128",
                   filter_gain=1 / 3, kernel_gain=1 / 3, norm_factor=1.0,
                   **kwargs):
    from .preview import preview_power_filter

    if size is None:
        # "WxH" widget string → (H, W) (py/nodes/powernoise.py:876-879)
        w, h = (int(v) for v in str(preview_size).split("x", 1))
        size = (h, w)
    return preview_power_filter(sonar_power_filter, size=size,
                                filter_gain=filter_gain, kernel_gain=kernel_gain,
                                normalization_factor=norm_factor, **kwargs)


# -- latent operations (py/nodes/latent_operations.py) ----------------------------


@register_node("SonarLatentOperationQuantileFilter")
def latent_op_quantile(*, dim="1", norm_factor=1.0, norm_power=0.5, **kwargs):
    return SonarLatentOperationQuantileFilter(
        dim=_QUANTILE_DIM_MAP.get(str(dim), 1), nq_fac=norm_factor,
        pow_fac=norm_power, **kwargs)


@register_node("SonarLatentOperationAdvanced")
def latent_op_advanced(*, operation=None, operation_alt=None, **kwargs):
    ops = [operation] if operation is not None else []
    for k in sorted(kwargs):
        if k.startswith("operation_") and k[10:].isdigit():
            op = kwargs.pop(k)
            if op is not None:
                ops.append(op)
    return SonarLatentOperationAdvanced(ops=tuple(ops), op_alt=operation_alt,
                                        **kwargs)


@register_node("SonarLatentOperationNoise")
def latent_op_noise(*, custom_noise, **kwargs):
    kwargs.pop("cpu_noise", None)
    kwargs.pop("lazy_noise_sampler", None)
    return SonarLatentOperationNoise(custom_noise=custom_noise, **kwargs)


@register_node("SonarLatentOperationSetSeed")
def latent_op_set_seed(*, seed=0, restore_rng_state=True, operation=None,
                       op=None, **kwargs):
    """Counter-based keys make RNG save/restore a no-op; the seed feeds the
    wrapped op's stream when it takes one (py/latent_ops.py:189-209).
    The reference input name is ``operation``; ``op`` kept as an alias."""
    del restore_rng_state
    if operation is not None:
        op = operation
    if isinstance(op, SonarLatentOperationNoise):
        op.seed = seed
    return SonarLatentOperation(op=op, **kwargs)


@register_node("SonarApplyLatentOperationCFG")
def apply_latent_op_cfg(*, operation=None, mode="denoised_sub_uncond",
                        model=None, **kwargs):
    from .guider import make_latent_op_cfg_function

    # the reference patches the MODEL in place; here the returned (fn, hook)
    # pair *is* the patch, so a passed model is not needed and ignored.
    del model
    ops = [operation] if operation is not None else []
    for k in sorted(kwargs):
        if k.startswith("operation_") and k[10:].isdigit():
            op = kwargs.pop(k)
            if op is not None:
                ops.append(op)
    return make_latent_op_cfg_function(operations=tuple(ops), mode=mode, **kwargs)


# -- misc (py/nodes/misc.py) -------------------------------------------------------


@register_node("NoisyLatentLike")
def noisy_latent_like_node(*, latent, **kwargs):
    kwargs.pop("cpu_noise", None)  # the latent's device picks placement
    custom = kwargs.pop("custom_noise_opt", None)
    # reference optional-input names (py/nodes/misc.py): mul_by_sigmas_opt is
    # the SIGMAS input; model_opt is the MODEL input (used only for its
    # model_sampling object, which is what this framework takes directly).
    if "mul_by_sigmas_opt" in kwargs:
        kwargs.setdefault("mul_by_sigmas", kwargs.pop("mul_by_sigmas_opt"))
    if "model_opt" in kwargs:
        kwargs.setdefault("model_sampling", kwargs.pop("model_opt"))
    return noisy_latent_like(_as_tensor(latent), custom_noise=custom, **kwargs)


@register_node("SonarNoiseImage")
def noise_image_node(*, image, **kwargs):
    kwargs.pop("cpu_noise", None)
    kwargs.pop("dtype", None)
    custom = kwargs.pop("custom_noise_opt", None)
    return noise_image(_as_tensor(image), custom_noise=custom, **kwargs)


@register_node("BasicScheduler")
def basic_scheduler(*, scheduler="normal", steps=20, denoise=1.0,
                    model_sampling=None):
    """ComfyUI core scheduler node, implemented natively so ported
    workflows carry their sigma schedules (samplers/schedules.py)."""
    from ..samplers.schedules import get_sigmas

    return get_sigmas(scheduler, steps, model_sampling, denoise=denoise)


@register_node("KarrasScheduler")
def karras_scheduler(*, steps=20, sigma_max=14.614642, sigma_min=0.0291675,
                     rho=7.0):
    from ..samplers.schedules import karras_sigmas

    return karras_sigmas(steps, sigma_min, sigma_max, rho=rho)


@register_node("ExponentialScheduler")
def exponential_scheduler(*, steps=20, sigma_max=14.614642,
                          sigma_min=0.0291675):
    from ..samplers.schedules import exponential_sigmas

    return exponential_sigmas(steps, sigma_min, sigma_max)


@register_node("PolyexponentialScheduler")
def polyexponential_scheduler(*, steps=20, sigma_max=14.614642,
                              sigma_min=0.0291675, rho=1.0):
    from ..samplers.schedules import polyexponential_sigmas

    return polyexponential_sigmas(steps, sigma_min, sigma_max, rho=rho)


@register_node("KSamplerSelect")
def ksampler_select(*, sampler_name):
    """ComfyUI core sampler selector, resolved against the native sampler
    registry (sonar_* + restart + the plain k-diffusion set,
    samplers/kdiffusion.py) so workflows that wrap a host sampler in
    SamplerConfigOverride execute end-to-end — the reference corpus
    samples with dpmpp_2s_ancestral (docs/base_noise_types.md:3-9)."""
    return get_sampler(sampler_name)


@register_node("SonarToComfyNOISE")
def to_comfy_noise(*, sonar_custom_noise, **kwargs):
    """Adapter exposing ComfyUI's NOISE protocol surface
    (``generate_noise(input_latent)``) — py/nodes/misc.py:360-419,
    including the batch_index remapping: noise is generated per unique
    batch index with seed+idx (wrapping into the latent batch), skipped
    indices still advance the seed sequence, and the draws are gathered
    back in inverse order (misc.py:395-419)."""
    from ..noise.base import make_noise_sampler as _mns

    class _Noise:
        def __init__(self, item, seed=0, *, normalize=True, multiplier=1.0):
            self.item = item
            self.seed = seed
            self.normalize = normalize
            self.multiplier = multiplier

        def _sample_noise(self, samples, seed):
            fn, state = _mns(self.item, tuple(samples.shape), dtype=samples.dtype,
                             device=samples.device, seed=seed, normalized=self.normalize,
                             ref_latent=samples)
            noise, _ = fn(state, None, None)
            return noise if self.multiplier == 1.0 else noise * self.multiplier

        def generate_noise(self, input_latent):
            is_dict = isinstance(input_latent, dict)
            samples = _as_tensor(
                input_latent["samples"] if is_dict else input_latent)
            batch_inds = input_latent.get("batch_index") if is_dict else None
            if self.multiplier == 0.0:
                return torch.zeros_like(samples)
            if batch_inds is None:
                return self._sample_noise(samples, self.seed)
            unique_inds, inverse_inds = np.unique(
                np.asarray(batch_inds), return_inverse=True)
            batch_size = samples.shape[0]
            # the reference must generate-and-discard absent indices
            # because its draws advance torch's global RNG; ours seed each
            # draw explicitly with seed+idx, so skipping the absent
            # indices is bit-identical and avoids the throwaway work
            result = [
                self._sample_noise(samples[int(idx) % batch_size][None],
                                   self.seed + int(idx))
                for idx in unique_inds
            ]
            return torch.cat([result[i] for i in inverse_inds], dim=0)

    return _Noise(sonar_custom_noise.clone(), kwargs.get("seed", 0),
                  normalize=kwargs.get("normalize", True),
                  multiplier=kwargs.get("multiplier", 1.0))


# The reference registers this node under the literal mapping name
# "SONAR_CUSTOM_NOISE to NOISE" (py/nodes/misc.py:902); alias it so workflow
# JSON ports 1:1. It also names the noise input ``custom_noise``.
@register_node("SONAR_CUSTOM_NOISE to NOISE")
def to_comfy_noise_refname(*, custom_noise=None, sonar_custom_noise=None, **kwargs):
    return to_comfy_noise(
        sonar_custom_noise=custom_noise if custom_noise is not None
        else sonar_custom_noise, **kwargs)


@register_node("SonarSplitNoiseChain")
def split_chain(*, factor=1.0, rescale=0.0, normalize=None,
                sonar_custom_noise_opt=None, custom_noise=None):
    """Split off a sub-chain as one chain link (py/nodes/misc.py:628-663):
    the node wraps ``custom_noise`` in a BlendedNoise whose blend function
    returns only the first input, so the wrapped chain contributes as a
    single normalized item of the outer chain."""
    item = None
    if custom_noise is not None:
        item = BlendedNoise(factor, blend_function=lambda a, _b, _t: a,
                            normalize=tristate(normalize),
                            custom_noise_1=custom_noise.clone(),
                            custom_noise_2=None, noise_2_percent=0.0)
    return _chain(item, factor, rescale, sonar_custom_noise_opt)


@register_node("SonarWaveletCFG")
def wavelet_cfg_node(*, yaml_parameters=None, existing_cfg=None,
                     fallback_mode=None, operation_cond=None,
                     operation_uncond=None, operation_fallback_cfg=None,
                     operation_wavelet_cfg=None, operation_result=None,
                     **kwargs):
    params = dict(kwargs)
    # the node widget's -1 sentinel means "model sigma_max"; the reference
    # converts it to inf BEFORE the YAML merge, so a YAML-supplied negative
    # start_sigma stays raw (py/nodes/misc.py:864-866)
    if params.get("start_sigma", 0.0) < 0:
        params["start_sigma"] = math.inf
    if yaml_parameters:
        parsed = safe_load_yaml(yaml_parameters)
        if parsed:
            params |= parsed
    # fallback_mode widget: "existing" keeps a connected CFG function as the
    # fallback, "own" forces the plain-CFG fallback (py/nodes/misc.py:700-712).
    if fallback_mode is not None:
        params.setdefault("fallback_existing", fallback_mode == "existing")
    rules = WCFGRules.build(**params)
    return WaveletCFG(rules=rules, existing_cfg=existing_cfg,
                      operation_cond=operation_cond,
                      operation_uncond=operation_uncond,
                      operation_fallback_cfg=operation_fallback_cfg,
                      operation_wavelet_cfg=operation_wavelet_cfg,
                      operation_result=operation_result)


# -- FreeU (py/nodes/freeu_extreme.py) ---------------------------------------------


@register_node("FreeUExtremeConfig")
def freeu_config(*, sonar_power_filter_opt=None, frux_config_opt=None, **kwargs):
    return FreeUExtremeConfig(sonar_power_filter=sonar_power_filter_opt,
                              frux_config=frux_config_opt, **kwargs)


@register_node("FreeUExtreme")
def freeu_extreme(*, model_sampling, model_channels, input_config=None,
                  middle_config=None, output_config=None, cpu_fft=False):
    del cpu_fft  # the UNet's device picks placement
    from ..cfg import make_freeu_patches

    return make_freeu_patches(
        model_sampling=model_sampling, model_channels=model_channels,
        input_config=input_config, middle_config=middle_config,
        output_config=output_config)


# -- integrations (py/nodes/integrations.py) ---------------------------------------
# All four integration nodes are implemented natively (the reference gates
# them on the external bleh / restart_sampling packs): BlendFilterNoise,
# BlehOpsNoise (sonar_tpu_torch.noise.ops_engine), and both restart samplers.


@register_node("SonarBlendFilterNoise")
def blend_filter_noise(*, factor=1.0, sonar_custom_noise, blend_mode="simple_add",
                       ffilter=None, ffilter_custom="", ffilter_scale=1.0,
                       ffilter_strength=0.0, ffilter_threshold=1,
                       enhance_mode="none", enhance_strength=0.0, affect="result",
                       normalize_noise=None, normalize_result=None):
    from ..noise.blendfilter import BlendFilterNoise

    # ffilter_custom: comma-separated gain list overriding the preset
    # (py/nodes/integrations.py:81-86); "none" preset → no filter.
    if isinstance(ffilter_custom, str) and ffilter_custom.strip():
        import ast

        ffilter = tuple(ast.literal_eval(f"[{ffilter_custom.strip()}]"))
    elif ffilter == "none":
        ffilter = None
    return _chain(
        BlendFilterNoise(factor, noise=sonar_custom_noise.clone(),
                         blend_mode=blend_mode, ffilter=ffilter,
                         ffilter_scale=ffilter_scale,
                         ffilter_strength=ffilter_strength,
                         ffilter_threshold=ffilter_threshold,
                         enhance_mode=enhance_mode,
                         enhance_strength=enhance_strength, affect=affect,
                         normalize_noise=tristate(normalize_noise),
                         normalize_result=tristate(normalize_result)),
        factor)


def _parse_restart_segments(segments):
    """Parse the restart_sampling segment mini-language: a comma-separated
    list of ``[n, k, t_min, t_max]`` brackets (or the literal "default")."""
    from ..samplers.restart import RestartSegment

    if segments is None or (isinstance(segments, str)
                            and segments.strip().lower() in ("", "default")):
        return None
    if isinstance(segments, str):
        import ast

        parsed = ast.literal_eval(f"[{segments.strip()}]")
        return tuple(
            RestartSegment(n=int(n), k=int(k), t_min=float(t_min),
                           t_max=float(t_max))
            for n, k, t_min, t_max in parsed
        )
    return tuple(segments)


def _restart_builder(**kwargs):
    from functools import partial

    from ..samplers.restart import sample_restart

    custom_noise = kwargs.pop("custom_noise_opt", None) or kwargs.pop(
        "custom_noise", None) or kwargs.pop("sonar_custom_noise", None)
    inner = kwargs.pop("sampler", None)
    if isinstance(inner, str):
        from .functions import get_sampler

        inner = get_sampler(inner)
    kwargs.setdefault("seed", kwargs.pop("noise_seed", None))
    segments = _parse_restart_segments(kwargs.pop("segments", None))
    if segments is not None:
        kwargs["segments"] = segments
    # ComfyUI-pipeline-level inputs the reference node consumes before the
    # sampler runs (model/conds/schedule construction and chunked preview
    # batching); the returned callable here takes (model, x, sigmas) directly.
    for pipeline_only in ("model", "add_noise", "steps", "cfg", "positive",
                          "negative", "latent_image", "start_at_step",
                          "end_at_step", "return_with_leftover_noise",
                          "chunked_mode", "scheduler", "restart_scheduler"):
        kwargs.pop(pipeline_only, None)
    return partial(sample_restart, custom_noise=custom_noise,
                   inner_sampler=inner, **kwargs)


@register_node("KRestartSamplerCustomNoise")
def krestart_sampler(**kwargs):
    return _restart_builder(**kwargs)


@register_node("RestartSamplerCustomNoise")
def restart_sampler(**kwargs):
    return _restart_builder(**kwargs)


@register_node("SonarBlehOpsNoise")
def bleh_ops_noise(*, factor=1.0, sonar_custom_noise, rules="", normalize=None,
                   reference=None):
    """Native ops rule engine replaces the bleh block-ops interpreter — see
    sonar_tpu_torch.noise.ops_engine for the documented rule schema."""
    from ..noise.ops_engine import BlehOpsNoise

    return _chain(
        BlehOpsNoise(factor, noise=sonar_custom_noise.clone(), rules=rules,
                     normalize=tristate(normalize), reference=reference),
        factor)
