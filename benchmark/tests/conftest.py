"""Small sizes of the benchmark's cells for the CPU, found by name: each
configuration's file with ``small/configs/<config>.json`` laid over it, each
traffic file with ``small/traffic/<traffic>.json`` (the widths, shapes and
steps cut so that a whole run takes seconds). A cell whose configuration
or traffic has no small file fails its tests, naming the file to add.

Besides the cells of ``BENCHMARK.json``, ``small/cells/<name>.json`` holds
mixes that only the tests run (a configuration, a whole traffic mix at a
small size, and the limits to hold it to)."""

import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark import traffic as T  # noqa: E402

SMALL = pathlib.Path(__file__).resolve().parent / "small"


def _read(path: pathlib.Path) -> dict:
    if not path.is_file():
        pytest.fail(f"no small size: add {path.relative_to(ROOT)}", pytrace=False)
    return json.loads(path.read_text())


def _test_only(name: str) -> dict | None:
    path = SMALL / "cells" / f"{name}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def small_config(name: str) -> dict:
    """Configuration ``name`` at its small size."""
    return dict(T.load("configs", name), **_read(SMALL / "configs" / f"{name}.json"))


def small_cell(name: str):
    """(config, traffic) of cell ``name`` at a size the CPU runs in seconds."""
    only = _test_only(name)
    if only is not None:
        return small_config(only["config"]), dict(only["traffic"])
    cell = next(w for w in harness.load_bench()["workloads"] if w["name"] == name)
    traffic = dict(T.load("traffic", cell["traffic"]),
                   **_read(SMALL / "traffic" / f"{cell['traffic']}.json"))
    return small_config(cell["config"]), traffic


def cell_traffic(name: str) -> dict:
    """Cell ``name``'s traffic at its own size (read at collection, where a
    missing small file must not stop the module)."""
    only = _test_only(name)
    if only is not None:
        return dict(only["traffic"])
    cell = next(w for w in harness.load_bench()["workloads"] if w["name"] == name)
    return T.load("traffic", cell["traffic"])


def run_small(name: str, seed: int, trace: bool = False) -> dict:
    """One whole run of cell ``name`` at its small size on the CPU, held to
    the cell's own limits."""
    config, traffic = small_cell(name)
    bench, limits = harness.load_bench(), None
    only = _test_only(name)
    if only is not None:
        cell = {"name": name, "config": only["config"], "traffic": name, "chips": 1}
        bench = dict(bench, workloads=[cell])
        limits = only["limits"]
    return harness.run_cell(name, seed=seed, seconds=0.0, trace=trace, device="cpu", t_start=0.0,
                            bench=bench, config=config, traffic=traffic, limits=limits,
                            log=lambda m: None)


def cells():
    """The cells of ``BENCHMARK.json`` and the mixes only the tests run."""
    return ([w["name"] for w in harness.load_bench()["workloads"]]
            + sorted(p.stem for p in (SMALL / "cells").glob("*.json")))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
