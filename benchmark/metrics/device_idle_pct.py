"""device_idle_pct: the share of the traced calls' wall time (their
``image`` spans) in which no operation ran on the device."""


def read(run):
    t = run["trace"]
    if not t or not t["window_s"] or not t["ops"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
