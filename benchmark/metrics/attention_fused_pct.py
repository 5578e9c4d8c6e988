"""attention_fused_pct: the share of the attention core's calls that ran the
fused kernel (B7, ``csrc/attention.cu``), in %: the kernel's launches among
the device operations of the traced calls (``attention_ffma_kernel`` and
``attention_tf32_kernel``, one a call) over the program's ``sonar.attention``
spans in the same calls (``span_totals()``,
``sonar_tpu_torch.utils.profiling``). None without a trace, where the
program records no attention span, or where it has no such kernel."""

import importlib
import importlib.util

NAMES = ("attention_ffma_kernel", "attention_tf32_kernel")


def read(run):
    t = run["trace"]
    if not t or importlib.util.find_spec("sonar_tpu_torch.kernels.attention") is None:
        return None
    profiling = importlib.import_module("sonar_tpu_torch.utils.profiling")
    span_totals = getattr(profiling, "span_totals", None)
    spans = span_totals().get("sonar.attention") if span_totals is not None else None
    if not spans or not spans["count"]:
        return None
    n = sum(1 for k in t["ops"] if k["kind"] == "kernel" and any(x in k["name"] for x in NAMES))
    return 100.0 * n / spans["count"]
