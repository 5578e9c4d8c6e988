"""B1, the fused momentum step (``csrc/fused.cu`` ``momentum_step_kernel``):
reads x, denoised, the history and the noise, writes x' and the history',
and reads the ten step scalars; 27 operations an element, those of the
momentum chain written out (two lerps of the history, the derivative, the
mix, the Euler step, the noise)."""

import math

from ._bound import least

NAMES = ("momentum_step_kernel",)
INSTR = 27


def least_seconds(traffic: dict, itemsize: int = 4) -> float:
    n = math.prod(traffic["shape"])  # one launch covers the whole latent
    return least(6 * itemsize * n + 40, INSTR * n)
