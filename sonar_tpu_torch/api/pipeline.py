"""SonarPipeline (port of ``sonar_tpu.api.pipeline``): the everything-wired
surface. The reference's user surface is a ComfyUI graph (KSampler,
custom-noise chain, WaveletCFG model patch); this class is that graph as one
object: cond/uncond denoisers (or one batched denoiser), a sampler name, a
noise tree, and optional wavelet-CFG rules and CFG-time latent ops; call it
with (x0, sigmas).

The run is eager PyTorch. The schedule becomes host numbers once a run; each
guided call receives the step's sigma from the sampler as a host number
(``sigma_host``) beside the sigma batch on the device and hands both to the
CFG function, so choosing a wavelet-CFG rule, its percentages and the
latent-op gates read nothing back from the card.

A dp-sharded latent (a ``DTensor`` from ``parallel.shard_latent``) goes to
the sampler as it is: the sampler steps each rank's rows, so the guided
denoiser, and ``model_batched``'s doubled batch, see this rank's rows only.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Any, Callable

import numpy as np
import torch

from ..cfg import DiscreteSampling, Flow, WaveletCFG, basic_cfg
from ..cfg.model_sampling import max_denoise
from ..models.prediction import CONST, EPS, get_prediction
from ..noise.base import NoiseItem
from ..samplers.momentum import SonarConfig
from ..utils.profiling import span
from .functions import get_sampler


class SonarPipeline:
    def __init__(
        self,
        *,
        model: Callable | None = None,
        model_uncond: Callable | None = None,
        model_batched: Callable | None = None,
        sampler: str | Callable = "sonar_euler_ancestral",
        sonar_config: SonarConfig | None = None,
        noise: NoiseItem | None = None,
        cfg_scale: float = 7.5,
        wavelet_cfg: WaveletCFG | None = None,
        latent_op_cfg: tuple | None = None,  # (patch_fn, hook) from api.guider
        model_sampling=None,
        eta: float | None = None,
        s_noise: float | None = None,
        seed: int | None = None,
        fused_noise: bool | None = None,
    ):
        """``model(x, sigma_batch) -> denoised`` is the cond denoiser;
        ``model_uncond`` enables CFG (basic or wavelet). Without it the
        pipeline samples unguided, the reference's KSampler path.

        ``model_batched(x2, sigma2, **kw) -> denoised2`` is the alternative
        to the (model, model_uncond) pair: one denoiser call on the doubled
        batch, rows ``[:B]`` conditional and rows ``[B:]`` unconditional (the
        caller bakes the two conditionings in, as ComfyUI batches cond and
        uncond into one UNet forward). The CFG machinery is unchanged.
        Exclusive with ``model_uncond`` and with ``model``.

        ``fused_noise`` is accepted for the JAX package's signature, where
        it turns its fused pyramid kernels on or off. The port has no such
        switch: every noise draw on the card runs the hand-written kernels
        and on the CPU their plain versions, whatever the value."""
        if model_batched is not None and model_uncond is not None:
            raise ValueError(
                "model_batched and model_uncond are mutually exclusive: "
                "the batched callable already produces both halves")
        if model_batched is not None and model is not None:
            raise ValueError(
                "model_batched and model are mutually exclusive: the batched callable "
                "already produces the conditional half (rows [:B]); passing both would "
                "silently ignore model")
        self.model = model
        self.model_uncond = model_uncond
        self.model_batched = model_batched
        self.sampler = get_sampler(sampler) if isinstance(sampler, str) else sampler
        self.sonar_config = sonar_config
        self.noise = noise
        self.cfg_scale = cfg_scale
        self.wavelet_cfg = wavelet_cfg
        self.latent_op_cfg = latent_op_cfg
        self.model_sampling = model_sampling or DiscreteSampling()
        self.eta = eta
        self.s_noise = s_noise
        self.seed = seed
        self.fused_noise = fused_noise

    # -- guided denoiser assembly (replaces ComfyUI's CFGGuider) ---------------
    def _denoiser(self, sample_sigmas) -> Callable:
        model = self.model
        batched = self.model_batched
        if model is None and batched is None:
            raise ValueError("SonarPipeline requires a model callable")
        if self.model_uncond is None and batched is None:
            def unguided(x, sigma_batch, **kw):
                with span("sonar.model"):
                    return model(x, sigma_batch, **kw)

            unguided.takes_sigma_host = getattr(model, "takes_sigma_host", False)
            return unguided

        uncond = self.model_uncond
        cfg_fn = self.wavelet_cfg if self.wavelet_cfg is not None else basic_cfg
        lo_patch, lo_hook = self.latent_op_cfg or (None, None)
        ms = self.model_sampling

        def guided(x, sigma_batch, *, sigma_host=None, **kw):
            with span("sonar.guidance"):
                base = dict(sigma=sigma_batch, sigma_host=sigma_host, model_sampling=ms)
                if lo_hook == "model_input":
                    x = lo_patch(dict(input=x, **base))
                if batched is not None:
                    # one denoiser call on the doubled batch: [cond | uncond]
                    b = x.shape[0]
                    s2 = sigma_batch if sigma_batch.ndim == 0 else torch.cat(
                        [sigma_batch, sigma_batch], 0)
                    x2 = torch.cat([x, x], dim=0)
                    with span("sonar.model"):
                        d2 = batched(x2, s2, **kw)
                    cond_d, uncond_d = d2[:b], d2[b:]
                else:
                    with span("sonar.model"):
                        cond_d = model(x, sigma_batch, **kw)
                    with span("sonar.model"):
                        uncond_d = uncond(x, sigma_batch, **kw)
                if lo_hook == "pre_cfg":
                    conds = lo_patch(dict(input=x, conds_out=[cond_d, uncond_d], **base))
                    cond_d, uncond_d = conds[0], conds[1]
                args = dict(input=x, cond=x - cond_d, uncond=x - uncond_d,
                            cond_denoised=cond_d, uncond_denoised=uncond_d,
                            cond_scale=self.cfg_scale, sample_sigmas=sample_sigmas, **base)
                out = x - cfg_fn(args)
                if lo_hook == "post_cfg":
                    out = lo_patch(dict(input=x, denoised=out, uncond_denoised=uncond_d, **base))
                return out

        # the port's samplers pass the step's host sigma to a model that says
        # it takes one (samplers/sonar.py)
        guided.takes_sigma_host = True
        return guided

    def _sampler_params(self) -> frozenset | None:
        """Keyword names the sampler accepts, or None for "everything"
        (a ``**kwargs`` signature or an uninspectable callable)."""
        try:
            sig = inspect.signature(self.sampler)
        except (TypeError, ValueError):
            return None
        if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
            return None
        return frozenset(sig.parameters)

    def __call__(self, x0: torch.Tensor, sigmas, **kwargs) -> torch.Tensor:
        # the schedule stays float32 whatever the latent's type, and its host
        # copy feeds wavelet CFG's step windows (one read a run)
        host_sigmas = np.asarray(torch.as_tensor(sigmas).detach().to("cpu", torch.float32))
        denoiser = self._denoiser(host_sigmas)
        call_kwargs: dict[str, Any] = dict(kwargs)
        # pipeline-level defaults are forwarded only to a sampler that takes
        # them (sonar_euler takes no noise_item/eta/s_noise); caller-passed
        # kwargs stay strict
        accepts = self._sampler_params()
        for name, value in (("sonar_config", self.sonar_config),
                            ("noise_item", self.noise),
                            ("eta", self.eta),
                            ("s_noise", self.s_noise),
                            ("seed", self.seed)):
            if value is not None and (accepts is None or name in accepts):
                call_kwargs.setdefault(name, value)
        # flow models default ancestral samplers to the rectified-flow noise
        # split, only for samplers that declare the knob
        if isinstance(self.model_sampling, Flow) and accepts is not None:
            if "ancestral_mode" in accepts:
                call_kwargs.setdefault("ancestral_mode", "rf")
            elif {"eta", "s_noise"} & set(accepts):
                warnings.warn(
                    f"Flow model_sampling with sampler "
                    f"{getattr(self.sampler, '__name__', self.sampler)!r}: this sampler "
                    "injects VP-style noise and has no ancestral_mode='rf' support; flow "
                    "latents will be over-noised. Prefer sonar_euler_ancestral, or eta=0.",
                    stacklevel=2)
        return self.sampler(denoiser, x0, torch.from_numpy(host_sigmas), **call_kwargs)

    # -- host-side latent contract (ComfyUI applies these around sampling) ----
    def _prediction(self, prediction=None):
        if prediction is not None:
            return get_prediction(prediction)
        return CONST() if isinstance(self.model_sampling, Flow) else EPS()

    @staticmethod
    def _sigma_at(sigmas, i: int) -> torch.Tensor:
        """Entry ``i`` of the schedule as a float32 CPU scalar, which meets a
        latent on any device in float32."""
        return torch.as_tensor(sigmas).detach().to("cpu", torch.float32).reshape(-1)[i]

    def prepare_latent(self, latent, noise, sigmas, *, prediction=None):
        """Noise a clean latent to ``sigmas[0]`` (the img2img entry contract,
        ``model_sampling.noise_scaling`` in ComfyUI's CFGGuider.sample). EPS
        models add ``sigma0 * noise`` (``sqrt(1+sigma0^2)`` when sigma0
        reaches sigma_max: the max-denoise rule, reference misc.py:99-106);
        flow models interpolate ``sigma0*noise + (1-sigma0)*latent``.
        ``prediction`` overrides the default (CONST for Flow, EPS otherwise)."""
        pred = self._prediction(prediction)
        s0 = self._sigma_at(sigmas, 0)
        return pred.noise_scaling(s0, noise, latent,
                                  max_denoise=max_denoise(self.model_sampling, float(s0)))

    def finalize_latent(self, samples, sigmas, *, prediction=None):
        """Undo latent-side scaling at the END sigma: identity for EPS and for
        any schedule ending at 0; ``latent / (1 - sigma_end)`` for flow
        models stopped early (ComfyUI's inverse_noise_scaling)."""
        pred = self._prediction(prediction)
        s_end = self._sigma_at(sigmas, -1)
        if isinstance(pred, CONST) and float(s_end) >= 1.0 - 1e-6:
            raise ValueError(
                f"finalize_latent: flow inverse scaling divides by (1 - sigma_end) but the "
                f"schedule ends at {float(s_end)}; the latent is still (nearly) pure noise; "
                "sample further before finalizing")
        return pred.inverse_noise_scaling(s_end, samples)

    def jit(self) -> Callable:
        """A runner ``fn(x0, sigmas, *, extra_args=None, **kwargs) ->
        samples`` with the JAX package's signature. Here it runs the
        pipeline eagerly and forwards ``extra_args`` (e.g. ``{"params":
        weights}`` for a denoiser built with ``params_kwarg``) to the
        sampler: no compilation, no CUDA graph."""

        def run(x0, sigmas, *, extra_args=None, **kwargs):
            return self(x0, sigmas, extra_args={} if extra_args is None else extra_args,
                        **kwargs)

        return run
