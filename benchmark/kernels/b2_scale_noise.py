"""B2, scale_noise on a whole latent (``csrc/fused.cu``
``scale_noise_one_kernel``, every tier): reads the draw once and writes it
once; 7 operations an element (the sum, the squared deviation, the
subtraction, the division and the factor)."""

import math

from ._bound import least

NAMES = ("scale_noise_one_kernel",)
INSTR = 7


def least_seconds(traffic: dict, itemsize: int = 4) -> float:
    n = math.prod(traffic["shape"])  # one launch covers the whole latent
    return least(2 * itemsize * n, INSTR * n)
