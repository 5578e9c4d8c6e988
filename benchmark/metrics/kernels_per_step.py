"""kernels_per_step: device kernels launched inside the traced calls over
their steps (an exact count: memory copies and sets are not kernels)."""


def read(run):
    t = run["trace"]
    if not t or not run["steps"]:
        return None
    n = sum(1 for k in t["ops"] if k["kind"] == "kernel")
    return n / run["steps"] if n else None
