"""step_p95_ms: the 95th percentile (linear between ranks) of every step of
the window, a step being the time between CUDA events recorded on the
stream at consecutive step ends (a call's first step from an event at its
start), recorded from the sampler's callback with no synchronisation."""

import math


def read(run):
    s = sorted(run["step_ms"])
    if not s:
        return None
    pos = (len(s) - 1) * 0.95
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)
