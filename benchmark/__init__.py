"""The benchmark of ``sonar_tpu_torch`` on one NVIDIA H100: whole images
through ``SonarPipeline``, timed in a closed loop and held to a plain
reference. ``run.py`` is the entry point; everything that belongs to one
configuration, traffic mix, per-layer metric, kernel bound, model family or
cell's limits is a file of its own, found by its name."""
