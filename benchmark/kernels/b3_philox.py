"""B3, the Philox4x32-10 Box-Muller normals (``csrc/hwrng.cu``
``philox_fill_kernel`` and its small and shard variants): writes the draw;
a Philox value and a Box-Muller share a normal."""

import math

from ._bound import NORMAL_INSTR, least

NAMES = ("philox_fill",)


def least_seconds(traffic: dict, itemsize: int = 4) -> float:
    n = math.prod(traffic["shape"])  # one launch covers the whole latent
    return least(itemsize * n, NORMAL_INSTR * n)
