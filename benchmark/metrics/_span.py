"""A program span's device time over the model calls of the traced calls,
in ms a model call: what ``rope_qknorm_ms`` reads. The spans are the
program's ``span_totals()`` (``sonar_tpu_torch.utils.profiling``), each
timed by a pair of CUDA events on the stream, and the model calls are its
``sonar.model`` spans."""

import importlib


def per_model_call(run, span: str):
    """None without a trace, or where the program records no ``span`` (or
    no spans of its own)."""
    if not run["trace"]:
        return None
    profiling = importlib.import_module("sonar_tpu_torch.utils.profiling")
    span_totals = getattr(profiling, "span_totals", None)
    t = span_totals() if span_totals is not None else None
    if not t or span not in t or "sonar.model" not in t:
        return None
    return t[span]["device_ms"] / t["sonar.model"]["count"]
