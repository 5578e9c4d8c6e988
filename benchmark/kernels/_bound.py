"""The least time of a launch: the larger of (bytes moved, every input read
once and every output written once) / HBM bandwidth and (arithmetic
operations the function needs on these inputs) / the float32 issue rate."""

from ..peaks import HBM_BYTES_S, INSTR_S

# One Philox4x32-10 call is 10 rounds of 2 mul.lo, 2 mul.hi, 4 xor and 2 add:
# 100 operations for four 32-bit values; Box-Muller adds a log, a sqrt, a cos,
# a sin, four multiplies and four conversions for two normals.
PHILOX_INSTR = 25  # per 32-bit value
NORMAL_INSTR = PHILOX_INSTR + 6  # per normal


def least(nbytes: float, instr: float) -> float:
    return max(nbytes / HBM_BYTES_S, instr / INSTR_S)
