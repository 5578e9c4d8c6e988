"""sonar_ms_per_step: device time of the operations launched outside any
``denoiser`` span (sampler, noise, guidance, pipeline) over the steps of the
traced calls (ms a step)."""


def read(run):
    t = run["trace"]
    if not t or not run["steps"]:
        return None
    s = sum(k["end"] - k["start"] for k in t["ops"] if not k["in_denoiser"])
    return s / 1e6 / run["steps"] if s else None
