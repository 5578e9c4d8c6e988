"""What the benchmark loads: whole runs of every cell (at a small size on
the CPU) in a fresh process load neither JAX nor the JAX package, and the
reference (every module under ``benchmark/reference/``, found by walking
it) and the check alone load no part of the program either. Names
are compared by their top-level part, whole: ``sonar_tpu_torch`` is not
``sonar_tpu``."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

RUN = """
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from conftest import cells, run_small
for name in cells():
    assert run_small(name, 5, trace=True)["correct"], name
import benchmark.run
"""

REFERENCE = """
import importlib, pkgutil
import benchmark.check, benchmark.reference
for m in pkgutil.walk_packages(benchmark.reference.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
"""


def _loaded(body: str) -> set:
    code = LOADED.format(root=str(ROOT), body=body.format(tests=str(ROOT / "benchmark" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT), check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_portbench_run_loads_no_jax():
    top = _loaded(RUN)
    assert "sonar_tpu_torch" in top and "benchmark" in top
    assert not top & {"jax", "jaxlib", "flax", "sonar_tpu"}, sorted(top)


def test_portbench_reference_loads_no_program():
    top = _loaded(REFERENCE)
    assert "benchmark" in top
    assert not top & {"jax", "jaxlib", "flax", "sonar_tpu", "sonar_tpu_torch"}, sorted(top)


def test_portbench_forbidden_names_whole():
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    fake = {"sonar_tpu_torch_x": False, "sonar_tpu_torchvision": False, "jax.numpy": True,
            "sonar_tpu.noise": True, "flax": True}
    added = [k for k in fake if k not in sys.modules]
    try:
        for k in added:
            sys.modules[k] = sys.modules[__name__]
        found = run.forbidden_modules()
        for k, bad in fake.items():
            assert (k in found) == bad, k
    finally:
        for k in added:
            sys.modules.pop(k, None)
