"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Nothing is built or loaded at import: the library is compiled at the
first launch on a CUDA tensor (see :mod:`._build`). The pyramid kernels B4
and B5 are reached through their module, ``kernels.fused_pyramid``, whose
name a function of the same name must not shadow; B6 through
``kernels.voronoi``."""

from .fused import (  # noqa: F401
    fused_momentum_step,
    fused_momentum_step_reference,
    fused_scale_noise,
    fused_scale_noise_reference,
    pack_momentum_scalars,
)
from .hwrng import (  # noqa: F401
    philox_rand,
    philox_rand_reference,
    philox_randn,
    philox_randn_reference,
)
