"""Model families: the latent-diffusion UNet (flagship) and the DiT
transformer (dense or Switch-MoE) as ``nn.Module``s, the prediction wrappers,
the training step, checkpoints and the FLOP counters. The DiT's sharded
paths (pipeline, tensor and expert parallelism) belong to the parallel tier
and are not here."""

from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
from .dit import (  # noqa: F401
    DiT,
    DiTConfig,
    dit_apply,
    dit_params_from_jax,
    init_dit_params,
    make_dit_denoiser,
)
from .flops import (  # noqa: F401
    H100_PEAK_FLOPS,
    dit_forward_flops,
    mfu_pct,
    unet_forward_flops,
)
from .prediction import (  # noqa: F401
    CONST,
    EPS,
    PREDICTIONS,
    V_PREDICTION,
    X0,
    get_prediction,
)
from .train import ema_update, init_train_state, make_train_step  # noqa: F401
from .unet import (  # noqa: F401
    UNet,
    UNetConfig,
    init_unet_params,
    make_denoiser,
    unet_apply,
    unet_params_from_jax,
)
