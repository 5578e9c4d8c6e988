"""denoiser_ms: device time of the operations launched inside ``denoiser``
spans, over the denoiser calls of the traced calls (ms a call)."""


def read(run):
    t = run["trace"]
    if not t or not run["spans"].calls:
        return None
    s = sum(k["end"] - k["start"] for k in t["ops"] if k["in_denoiser"])
    return s / 1e6 / run["spans"].calls if s else None
