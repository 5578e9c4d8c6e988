"""The frozen FLOP counts (``benchmark/flops/<family>.py``) equal the port's
(``families/<family>.py forward_flops``, ``models/flops.py``) at every
cell's shapes (each denoiser call's batch) and at small ones, and each
cell's FLOPs a step equal its record (``flops_per_step/<cell>.json``)."""

import importlib
import json
import math
import pathlib

import pytest
from conftest import small_config

from benchmark import harness
from benchmark import traffic as T

HERE = pathlib.Path(__file__).resolve().parent
CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


def _calls(traffic):
    """The shape of each denoiser call of a step: two calls of B images
    (``pair``), one of 2B (``batched``) or one of B (``none``)."""
    b, c, h, w = traffic["shape"]
    return {"pair": [(b, c, h, w)] * 2, "batched": [(2 * b, c, h, w)],
            "none": [(b, c, h, w)]}[traffic["cfg"]["mode"]]


def _frozen(config, shape):
    return importlib.import_module(f"benchmark.flops.{config['family']}").forward_flops(config,
                                                                                          shape)


def _port(config, shape):
    return importlib.import_module(f"benchmark.families.{config['family']}").forward_flops(config,
                                                                                             shape)


def _cell(name):
    cell = next(w for w in harness.load_bench()["workloads"] if w["name"] == name)
    return T.load("configs", cell["config"]), T.load("traffic", cell["traffic"])


@pytest.mark.parametrize("name", CELLS)
def test_portbench_flops_at_cells(name):
    config, traffic = _cell(name)
    for shape in _calls(traffic):
        assert _frozen(config, shape) == _port(config, shape)


@pytest.mark.parametrize("name", sorted({w["config"] for w in harness.load_bench()["workloads"]}))
@pytest.mark.parametrize("shape", [(1, 4, 16, 16), (3, 4, 32, 8)])
def test_portbench_flops_small(name, shape):
    config = small_config(name)
    assert _frozen(config, shape) == _port(config, shape)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_flops_per_step(name):
    """The FLOPs a step that PERF.md records."""
    path = HERE / "flops_per_step" / f"{name}.json"
    if not path.is_file():
        pytest.fail(f"no FLOPs-a-step record: add {path.relative_to(HERE.parents[1])}",
                    pytrace=False)
    config, traffic = _cell(name)
    got = sum(_frozen(config, shape) for shape in _calls(traffic))
    assert math.isclose(got, json.loads(path.read_text())["flops_per_step"], rel_tol=1e-12)


@pytest.mark.parametrize("mode, calls", [("pair", [(3, 4, 8, 8)] * 2), ("batched", [(6, 4, 8, 8)]),
                                         ("none", [(3, 4, 8, 8)])])
def test_portbench_calls_a_step(mode, calls):
    assert _calls({"shape": [3, 4, 8, 8], "cfg": {"mode": mode}}) == calls
