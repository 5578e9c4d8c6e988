"""attention_ms: the attention core's time (the program's ``sonar.attention``
spans: logits, scale, softmax, the value product) over the model calls
(``sonar.model`` spans) of the traced calls, in ms a model call. Read from
the program's ``span_totals()`` (``sonar_tpu_torch.utils.profiling``), each
span timed by a pair of CUDA events on the stream; None without a trace,
or where the program records no spans of its own."""

import importlib


def read(run):
    if not run["trace"]:
        return None
    profiling = importlib.import_module("sonar_tpu_torch.utils.profiling")
    span_totals = getattr(profiling, "span_totals", None)
    t = span_totals() if span_totals is not None else None
    if not t or "sonar.attention" not in t or "sonar.model" not in t:
        return None
    return t["sonar.attention"]["device_ms"] / t["sonar.model"]["count"]
