"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Nothing is built or loaded at import: the library is compiled at the
first launch on a CUDA tensor (see :mod:`._build`)."""

from .fused import (  # noqa: F401
    fused_momentum_step,
    fused_momentum_step_reference,
    fused_scale_noise,
    fused_scale_noise_reference,
    pack_momentum_scalars,
)
