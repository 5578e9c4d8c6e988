"""rope_qknorm_ms: the q/k RMSNorm, RoPE and packing of B7's buffer (the
program's ``sonar.rope`` spans, one a block) over the model calls
(``sonar.model`` spans) of the traced calls, in ms a model call. None
without a trace, or where the program records no such span (a model
without RoPE, or a program before it)."""

from ._span import per_model_call


def read(run):
    return per_model_call(run, "sonar.rope")
