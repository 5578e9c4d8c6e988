"""attention_roofline_pct: kernel B7's least time over its device time in
the traced calls, in %. B7's device time is that of its kernels
(``attention_ffma_kernel``, ``attention_tf32_kernel``) among the trace's
device operations. A launch's least time is its operations, from the
configuration family's ``attention_launch_flops`` (``families/<family>.py``,
for a family whose every launch in a model call has one shape), at the
dense TF32 tensor-core peak where the configuration turns matmul TF32 on,
at the float32 FMA peak where it does not. None without a trace, where no
B7 kernel ran, or where the family has no such count."""

import importlib

from ..peaks import INSTR_S

TF32_FLOPS = 495e12  # the H100 SXM5's dense TF32 tensor-core peak (NVIDIA's data sheet)
FFMA_FLOPS = 2 * INSTR_S  # float32 FMAs outside the tensor cores: 67 TFLOP/s
NAMES = ("attention_ffma_kernel", "attention_tf32_kernel")


def read(run):
    t = run["trace"]
    if not t:
        return None
    family = importlib.import_module(f"benchmark.families.{run['config']['family']}")
    launch_flops = getattr(family, "attention_launch_flops", None)
    times = [(k["end"] - k["start"]) / 1e9 for k in t["ops"]
             if k["kind"] == "kernel" and any(x in k["name"] for x in NAMES)]
    if launch_flops is None or not times:
        return None
    peak = TF32_FLOPS if run["config"]["matmul_allow_tf32"] else FFMA_FLOPS
    least = len(times) * launch_flops(run["config"], run["traffic"]["shape"]) / peak
    return least / sum(times) * 100.0
