"""steps_per_s: every sampler step of the window's calls over the window's
wall time, from the first call's start to the last call's end (its
synchronisation). Host clock."""


def read(run):
    return run["steps"] / run["window_s"] if run["steps"] else None
