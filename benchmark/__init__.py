"""The benchmark of ``sonar_tpu_torch`` on one NVIDIA H100: whole images
through ``SonarPipeline``, timed in a closed loop and held to a plain
reference. ``run.py`` is the entry point; everything that belongs to one
configuration, traffic mix, per-layer metric, kernel bound, model family or
cell's limits is a file of its own, found by its name.

A cell is added with new files and new ``BENCHMARK.json`` entries only:

- a configuration: ``configs/<config>.json`` (its ``family``) and, for a
  new family, ``families/<family>.py`` (``build``, ``forward_flops``,
  ``attention_axis``), ``reference/<family>.py`` (``param_specs``,
  ``network``) and ``flops/<family>.py``;
- a traffic mix: ``traffic/<traffic>.json`` (``traffic.py`` lists its keys;
  ``cfg.mode`` "none" and a flow ``model_sampling`` need no new code);
- a cell: ``limits/<cell>.json`` from ``calibrate.py``'s readings;
- its tests: ``tests/small/configs/<config>.json``,
  ``tests/small/traffic/<traffic>.json`` (the small sizes the CPU runs)
  and ``tests/flops_per_step/<cell>.json``."""
