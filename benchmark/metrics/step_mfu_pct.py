"""step_mfu_pct: the analytic forward FLOPs of every denoiser call of the
traced calls (``benchmark/flops/<family>.py`` at each call's shape) over
those calls' wall time, as a share of the H100's dense bf16 peak (the same
peak for every cell, whatever its precision)."""

from ..peaks import BF16_FLOPS


def read(run):
    t = run["trace"]
    if not t or not t["window_s"] or not run["spans"].flops or not t["ops"]:
        return None
    return run["spans"].flops / t["window_s"] / BF16_FLOPS * 100.0
