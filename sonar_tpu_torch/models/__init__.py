"""Model families: the latent-diffusion UNet (flagship), the DiT
transformer (dense or Switch-MoE) and FLUX.1's rectified-flow transformer
as ``nn.Module``s with the DiT's sharded
serving paths (pipeline, tensor and expert parallelism), the prediction
wrappers, the training step, checkpoints and the FLOP counters."""

from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
from .dit import (  # noqa: F401
    DiT,
    DiTConfig,
    dit_apply,
    dit_param_shardings,
    dit_params_from_jax,
    dit_pp_apply,
    init_dit_params,
    make_dit_denoiser,
    pp_stage_params,
    shard_dit_params,
)
from .flops import (  # noqa: F401
    H100_PEAK_FLOPS,
    dit_forward_flops,
    flux_forward_flops,
    mfu_pct,
    unet_forward_flops,
)
from .flux import (  # noqa: F401
    Flux,
    FluxConfig,
    init_flux_params,
    make_flux_denoiser,
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
