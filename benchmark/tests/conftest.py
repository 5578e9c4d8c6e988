"""Small sizes of the benchmark's cells for the CPU: the same files, with the
widths, shapes and steps cut so that a whole run takes seconds."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark import traffic as T  # noqa: E402

SMALL = {
    "unet-sd1": dict(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                            attention_levels=[1], num_heads=2, norm_groups=8),
    "dit-xl2": dict(hidden=64, depth=2, num_heads=4),
}
SMALL_SHAPE = {"1024-cfg7": [1, 4, 16, 16], "512-b4": [4, 4, 16, 16]}


def small_cell(name: str):
    """(config, traffic) of cell ``name`` at a size the CPU runs in seconds."""
    cell = next(w for w in harness.load_bench()["workloads"] if w["name"] == name)
    config = dict(T.load("configs", cell["config"]), **SMALL[cell["config"]])
    traffic = dict(T.load("traffic", cell["traffic"]), shape=SMALL_SHAPE[cell["traffic"]],
                   steps=4)
    return config, traffic


def cells():
    return [w["name"] for w in harness.load_bench()["workloads"]]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
