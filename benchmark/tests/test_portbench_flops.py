"""The frozen FLOP counts equal the port's ``models/flops.py`` at every
cell's shapes (each denoiser call's batch) and at small ones."""

import math

import pytest
from conftest import SMALL

from benchmark import harness
from benchmark import traffic as T
from benchmark.flops import dit, unet


def _calls(traffic):
    b, c, h, w = traffic["shape"]
    return [(b, c, h, w)] if traffic["cfg"]["mode"] == "pair" else [(2 * b, c, h, w)]


def _port(config, shape):
    from sonar_tpu_torch.models import flops
    from sonar_tpu_torch.models.dit import DiTConfig
    from sonar_tpu_torch.models.unet import UNetConfig

    if config["family"] == "unet":
        keys = ("in_channels", "out_channels", "model_channels", "num_res_blocks", "num_heads",
                "norm_groups")
        cfg = UNetConfig(**{k: config[k] for k in keys},
                         channel_mult=tuple(config["channel_mult"]),
                         attention_levels=tuple(config["attention_levels"]))
        return flops.unet_forward_flops(cfg, shape)
    keys = ("in_channels", "patch_size", "hidden", "depth", "num_heads", "mlp_ratio")
    return flops.dit_forward_flops(DiTConfig(**{k: config[k] for k in keys}), shape)


FROZEN = {"unet": unet.forward_flops, "dit": dit.forward_flops}


@pytest.mark.parametrize("name", [w["name"] for w in harness.load_bench()["workloads"]])
def test_portbench_flops_at_cells(name):
    cell = next(w for w in harness.load_bench()["workloads"] if w["name"] == name)
    config, traffic = T.load("configs", cell["config"]), T.load("traffic", cell["traffic"])
    for shape in _calls(traffic):
        assert FROZEN[config["family"]](config, shape) == _port(config, shape)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("shape", [(1, 4, 16, 16), (3, 4, 32, 8)])
def test_portbench_flops_small(name, shape):
    config = dict(T.load("configs", name), **SMALL[name])
    assert FROZEN[config["family"]](config, shape) == _port(config, shape)


def test_portbench_flops_per_step():
    """The FLOPs a step that PERF.md records."""
    want = {"sd1.1024-cfg7": 7.67619104768e12, "dit-xl2.512-b4": 8.392327299072e12}
    for cell in harness.load_bench()["workloads"]:
        config, traffic = T.load("configs", cell["config"]), T.load("traffic", cell["traffic"])
        per_call = len(_calls(traffic)) * (2 if traffic["cfg"]["mode"] == "pair" else 1)
        got = per_call * FROZEN[config["family"]](config, _calls(traffic)[0])
        assert math.isclose(got, want[cell["name"]], rel_tol=1e-12)
