"""Each piece of the plain reference against the port's function on the same
inputs, weights and seeds, at small sizes on the CPU. The tests import the
port; the reference does not."""

import math

import pytest
import torch
from conftest import SMALL, cells, small_cell

from benchmark import traffic as T
from benchmark import weights
from benchmark.reference import dit as ref_dit
from benchmark.reference import philox, sampling
from benchmark.reference import unet as ref_unet
from benchmark.reference.noise import gaussian
from benchmark.reference.pipelines import basic
from benchmark.reference.samplers import sonar_euler_ancestral

SEEDS = [0, 7, 2**31 + 12345, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_portbench_seed_chain(seed):
    from sonar_tpu_torch.core.rng import derive_seed, seed_from

    assert philox.seed_from(seed) == seed_from(seed)
    for path in [("noise",), ("noise", 3), (5, "rand_init"), (2**40,)]:
        assert philox.derive_seed(seed, *path) == derive_seed(seed, *path)


@pytest.mark.parametrize("shape", [(1, 4, 16, 16), (3, 5, 7), (4, 4, 8, 8)])
@pytest.mark.parametrize("seed", SEEDS)
def test_portbench_philox_normals(seed, shape):
    from sonar_tpu_torch.kernels.hwrng import philox_randn_reference

    want = philox_randn_reference(seed, shape, device="cpu")
    assert torch.equal(philox.randn(seed, shape, device="cpu"), want)


@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (0.3, 1.0), (0.0, 1.7), (-0.2, 0.5)])
def test_portbench_scale_noise(loc, scale):
    from sonar_tpu_torch.kernels.fused import fused_scale_noise_reference

    x = philox.randn(11, (1, 4, 32, 32), device="cpu") * scale + loc
    torch.testing.assert_close(sampling.scale_noise(x), fused_scale_noise_reference(x),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pair", [(14.6, 9.8), (1.2, 0.7), (0.03, 0.0)])
def test_portbench_ancestral_split(pair):
    from sonar_tpu_torch.samplers.ancestral import get_ancestral_step

    down, up = get_ancestral_step(*pair)
    assert sampling.ancestral_split(*pair) == (float(down), float(up))


def test_portbench_cfg_combine():
    from sonar_tpu_torch.cfg import basic_cfg

    x, c, u = (philox.randn(s, (1, 4, 8, 8), device="cpu") for s in (1, 2, 3))
    out = x - basic_cfg(dict(input=x, cond_denoised=c, uncond_denoised=u, cond_scale=7.0))
    torch.testing.assert_close(basic.guided(c, u, 7.0), out, rtol=1e-6, atol=1e-6)


def _port_module(family, config, params):
    from benchmark.families import dit, unet

    build = {"unet": unet, "dit": dit}[family].build
    models = build(config, params, {"shape": [1], "cfg": {"mode": "pair", "scale": 1.0,
                                                          "uncond_input_scale": 1.0}}, "cpu")
    return models["model"]


@pytest.mark.parametrize("family,ref", [("unet", ref_unet), ("dit", ref_dit)])
@pytest.mark.parametrize("sigma", [14.6, 0.5])
def test_portbench_network(family, ref, sigma):
    """The reference's denoised latent equals the port's denoiser on the
    same weights (eps preconditioning around the network)."""
    config = dict(T.load("configs", {"unet": "unet-sd1", "dit": "dit-xl2"}[family]),
                  **SMALL[{"unet": "unet-sd1", "dit": "dit-xl2"}[family]])
    params = weights.make(ref.param_specs(config), 5, "cpu")
    den = _port_module(family, config, params)
    x = philox.randn(9, (2, 4, 16, 16), device="cpu") * sigma
    sb = torch.full((2,), sigma)
    want = x - sigma * ref.network(params, config, x / math.sqrt(sigma**2 + 1), sb)
    torch.testing.assert_close(den(x, sb), want, rtol=1e-5, atol=1e-5 * sigma)


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_portbench_sampler(seed):
    """The reference's sonar Euler-ancestral run equals the port's (kernel
    B1's plain version on the CPU) with the same stub denoiser and the same
    seed: the noise stream, its normalization and the momentum chain."""
    from sonar_tpu_torch.samplers.sonar import sample_sonar_euler_ancestral

    t = dict(T.load("traffic", "1024-cfg7"), steps=8)
    sigmas = T.karras_sigmas(t)
    x0 = philox.randn(1, (1, 4, 16, 16), device="cpu") * 14.6
    w = philox.randn(2, (1, 4, 16, 16), device="cpu")

    def stub(x, s, **_):
        s = float(s.reshape(-1)[0]) if torch.is_tensor(s) else s
        return x * 0.9 - 0.05 * s * torch.tanh(x * w)

    got = sample_sonar_euler_ancestral(stub, x0, sigmas, seed=seed)
    want = sonar_euler_ancestral.sample(stub, x0, sigmas,
                                        noise=gaussian.sampler(seed, x0.shape, "cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_portbench_param_counts():
    """The configuration files' parameter counts are those of the specs."""
    for name, ref in (("unet-sd1", ref_unet), ("dit-xl2", ref_dit)):
        cfg = T.load("configs", name)
        assert sum(math.prod(s) for _, s, _, _ in ref.param_specs(cfg)) == cfg["params"]


@pytest.mark.parametrize("name", cells())
def test_portbench_whole_run_correct(name):
    """A sound run of each cell at a small size is correct under its limit."""
    from benchmark import harness

    config, traffic = small_cell(name)
    r = harness.run_cell(name, seed=2**31 + 77, seconds=0.0, trace=False, device="cpu",
                         t_start=0.0, config=config, traffic=traffic, log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] == traffic["check_calls"] and r["failed"] == 0
    assert r["checks"]["latent_gap"]["value"] < 5e-5  # float32 rounding, CFG 7 and 4 steps
