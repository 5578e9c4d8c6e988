"""Model families: the latent-diffusion UNet (flagship) and the prediction
wrappers. The DiT, the training tier and checkpoints come in later slices."""

from .prediction import (  # noqa: F401
    CONST,
    EPS,
    PREDICTIONS,
    V_PREDICTION,
    X0,
    get_prediction,
)
from .unet import (  # noqa: F401
    UNet,
    UNetConfig,
    init_unet_params,
    make_denoiser,
    unet_apply,
    unet_params_from_jax,
)
