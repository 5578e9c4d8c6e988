"""Prediction-type wrappers: what the raw network output *means* (port of
``sonar_tpu.models.prediction``; the arithmetic works on tensors and numbers
alike, so the code is the JAX package's).

The reference's samplers consume a host-wrapped denoiser — the host
normalizes every model parametrization (eps / v-prediction / x0 /
rectified-flow velocity) into ``model(x, sigma) -> denoised`` before the
sampler ever sees it. A standalone framework must ship that normalization
layer itself. These objects are that layer: each defines

- ``calculate_input(sigma, x)`` — the network input scaling (``sigma``
  already broadcast-shaped against ``x``, e.g. ``(B,1,1,1)``),
- ``calculate_denoised(sigma, model_output, x)`` — raw output → denoised,
- ``noise_scaling(sigma, noise, latent, max_denoise=False)`` — how a clean
  latent is noised to sigma (the img2img / initial-latent contract),
- ``inverse_noise_scaling(sigma, latent)`` — undo the latent-side scaling
  at the end of sampling (identity except for flow models).

``make_denoiser`` accepts ``prediction=`` and builds the wrapper in; every
sampler then works unchanged for eps, v-prediction, x0 and rectified-flow
models alike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EPS:
    """Noise prediction (SD1.x/SDXL): ``denoised = x - sigma * out``."""

    sigma_data: float = 1.0

    def calculate_input(self, sigma, x):
        return x / (sigma**2 + self.sigma_data**2) ** 0.5

    def calculate_denoised(self, sigma, model_output, x):
        return x - model_output * sigma

    def noise_scaling(self, sigma, noise, latent, max_denoise: bool = False):
        scaled = noise * (sigma**2 + 1.0) ** 0.5 if max_denoise else noise * sigma
        return scaled + latent

    def inverse_noise_scaling(self, sigma, latent):
        return latent


@dataclasses.dataclass(frozen=True)
class V_PREDICTION(EPS):
    """v-prediction (SD2.x-v, many fine-tunes):
    ``denoised = x * sd^2/(sigma^2+sd^2) - out * sigma*sd/sqrt(sigma^2+sd^2)``."""

    def calculate_denoised(self, sigma, model_output, x):
        sd2 = self.sigma_data**2
        return (x * sd2 / (sigma**2 + sd2)
                - model_output * sigma * self.sigma_data
                / (sigma**2 + sd2) ** 0.5)


@dataclasses.dataclass(frozen=True)
class X0(EPS):
    """Direct x0 prediction: the raw output IS the denoised latent."""

    def calculate_denoised(self, sigma, model_output, x):
        return model_output


@dataclasses.dataclass(frozen=True)
class CONST:
    """Rectified-flow velocity prediction (SD3/Flux family).

    Sigma is flow time in (0, 1]: ``x_t = (1-sigma)*x0 + sigma*noise`` and
    the network predicts the constant velocity ``noise - x0``, so
    ``denoised = x - sigma * out`` with NO input scaling."""

    def calculate_input(self, sigma, x):
        return x

    def calculate_denoised(self, sigma, model_output, x):
        return x - model_output * sigma

    def noise_scaling(self, sigma, noise, latent, max_denoise: bool = False):
        return sigma * noise + (1.0 - sigma) * latent

    def inverse_noise_scaling(self, sigma, latent):
        return latent / (1.0 - sigma)


_V = V_PREDICTION()
_CONST = CONST()
PREDICTIONS = {
    "eps": EPS(),
    "v_prediction": _V,
    "v": _V,
    "x0": X0(),
    "const": _CONST,
    "flow": _CONST,
}


def get_prediction(prediction):
    """Resolve a prediction spec: a name from :data:`PREDICTIONS` or any
    object with the calculate_input/calculate_denoised protocol."""
    if isinstance(prediction, str):
        try:
            return PREDICTIONS[prediction]
        except KeyError:
            raise ValueError(
                f"unknown prediction type {prediction!r}; "
                f"valid: {sorted(PREDICTIONS)}") from None
    if not (hasattr(prediction, "calculate_input")
            and hasattr(prediction, "calculate_denoised")):
        raise TypeError(
            "prediction must be a name or expose "
            "calculate_input/calculate_denoised")
    return prediction
