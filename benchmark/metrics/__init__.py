"""Per-layer metric readers, one file each: ``read(trace) -> float | None``
on the summary of a traced run (``benchmark/trace.py``). A reader that
finds nothing to read returns None and the metric is left out."""
