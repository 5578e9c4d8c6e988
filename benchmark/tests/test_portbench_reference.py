"""Each piece of the plain reference against the port's function on the same
inputs, weights and seeds, at small sizes on the CPU. The tests import the
port; the reference does not."""

import importlib
import math

import pytest
import torch
from conftest import cell_traffic, cells, run_small, small_cell, small_config

from benchmark import harness
from benchmark import traffic as T
from benchmark import weights
from benchmark.reference import philox, sampling
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


@pytest.mark.parametrize("pair", [(1.0, 0.8), (0.61, 0.2), (0.2, 0.0032), (0.0032, 0.0)])
@pytest.mark.parametrize("eta", [1.0, 0.5, 0.0])
def test_portbench_ancestral_split_rf(pair, eta):
    from sonar_tpu_torch.samplers.ancestral import get_ancestral_step_rf

    down, up, alpha = get_ancestral_step_rf(*pair, eta)
    assert sampling.ancestral_split_rf(*pair, eta) == (float(down), float(up), float(alpha))


def test_portbench_cfg_combine():
    from sonar_tpu_torch.cfg import basic_cfg

    x, c, u = (philox.randn(s, (1, 4, 8, 8), device="cpu") for s in (1, 2, 3))
    out = x - basic_cfg(dict(input=x, cond_denoised=c, uncond_denoised=u, cond_scale=7.0))
    torch.testing.assert_close(basic.guided(c, u, 7.0), out, rtol=1e-6, atol=1e-6)


CONFIGS = sorted({w["config"] for w in harness.load_bench()["workloads"]})
FLOW = {"multiplier": 1000.0}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("prediction", ["eps", "const"])
@pytest.mark.parametrize("sigma", [14.6, 0.5])
def test_portbench_network(name, prediction, sigma):
    """The reference's denoised latent equals the port's denoiser on the
    same weights: eps preconditioning around the network, or CONST under
    a flow model sampling (no input scaling, conditioned on σ·multiplier)."""
    config = small_config(name)
    ref = importlib.import_module(f"benchmark.reference.{config['family']}")
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    traffic = {"shape": [2], "cfg": {"mode": "none"}}
    if prediction == "const":
        traffic["model_sampling"] = FLOW
    params = weights.make(ref.param_specs(config), 5, "cpu")
    den = family.build(config, params, traffic, "cpu")["model"]
    x = philox.randn(9, (2, 4, 16, 16), device="cpu") * sigma
    sb = torch.full((2,), sigma)
    if prediction == "eps":
        want = x - sigma * ref.network(params, config, x / math.sqrt(sigma**2 + 1), sb)
    else:
        want = x - sigma * ref.network(params, config, x, sb * FLOW["multiplier"])
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


@pytest.mark.parametrize("seed", [4, 2**35 + 9])
def test_portbench_sampler_rf(seed):
    """The same under a flow model: the port's rectified-flow split (its
    composed path) against the reference's, on a flow schedule."""
    from sonar_tpu_torch.samplers.sonar import sample_sonar_euler_ancestral

    t = dict(T.load("traffic", "1024-cfg7"), steps=8, sigma_max=1.0, sigma_min=0.0032)
    sigmas = T.karras_sigmas(t)
    x0 = philox.randn(1, (2, 4, 8, 8), device="cpu")
    w = philox.randn(2, (2, 4, 8, 8), device="cpu")

    def stub(x, s, **_):
        s = float(s.reshape(-1)[0]) if torch.is_tensor(s) else s
        return x * (1.0 - s) - 0.3 * s * torch.tanh(x * w)

    got = sample_sonar_euler_ancestral(stub, x0, sigmas, seed=seed, ancestral_mode="rf")
    want = sonar_euler_ancestral.sample(stub, x0, sigmas, ancestral_mode="rf",
                                        noise=gaussian.sampler(seed, x0.shape, "cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    vp = sonar_euler_ancestral.sample(stub, x0, sigmas,
                                      noise=gaussian.sampler(seed, x0.shape, "cpu"))
    assert (vp - want).abs().max() > 1e-2  # the two splits differ


def test_portbench_param_counts():
    """The configuration files' parameter counts are those of the specs."""
    for name in CONFIGS:
        cfg = T.load("configs", name)
        ref = importlib.import_module(f"benchmark.reference.{cfg['family']}")
        assert sum(math.prod(s) for _, s, _, _ in ref.param_specs(cfg)) == cfg["params"], name


@pytest.mark.parametrize("name", cells())
def test_portbench_whole_run_correct(name):
    """A sound run of each cell at a small size is correct under its limit."""
    _, traffic = small_cell(name)
    r = run_small(name, 2**31 + 77)
    assert r["correct"], r["checks"]
    assert r["attempted"] == traffic["check_calls"] and r["failed"] == 0
    assert r["checks"]["latent_gap"]["value"] < 5e-5  # float32 rounding, CFG 7 and 4 steps


def test_portbench_model_sampling_reads_multiplier_only():
    """A flow mix states its multiplier alone: a shift would be stated and
    never applied (the schedule is Karras), so it is refused."""
    assert T.model_sampling({}) is None and T.prediction({}) == "eps"
    assert T.prediction({"model_sampling": {"multiplier": 1.0}}) == "const"
    with pytest.raises(ValueError, match="no shift applies"):
        T.model_sampling({"model_sampling": {"multiplier": 1.0, "shift": 3.1582}})


@pytest.mark.parametrize("takes_mode", [True, False])
def test_portbench_check_rf_where_the_sampler_takes_it(takes_mode, monkeypatch):
    """Under flow the check gives the reference sampler ``ancestral_mode``
    only where its ``sample`` takes that knob, as ``SonarPipeline`` does."""
    import sys
    import types

    from benchmark import check

    seen = {}

    def sample(denoise, x, sigmas, *, noise, eta=1.0, **kw):
        seen.update(kw)
        return x

    def sample_rf(denoise, x, sigmas, *, noise, eta=1.0, ancestral_mode="vp"):
        seen["ancestral_mode"] = ancestral_mode
        return x

    mod = types.ModuleType("benchmark.reference.samplers.stub")
    mod.sample = sample_rf if takes_mode else sample
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    config, traffic = small_cell(next(n for n in cells() if T.model_sampling(cell_traffic(n))))
    traffic = dict(traffic, sampler="stub", sonar_config={})
    check.reference_sampler(config, traffic, 3, "cpu")(0, T.karras_sigmas(traffic))
    assert seen == ({"ancestral_mode": "rf"} if takes_mode else {})
