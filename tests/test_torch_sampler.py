"""The port's samplers end to end against the JAX package.

Torch's Philox cannot reproduce JAX's threefry stream, so trajectories are
held equal with one injected numpy noise stream fed to both sides. The
deterministic ``euler`` golden fixture is reproduced directly. Tolerance:
1e-4 relative to the trajectory's largest magnitude (convolutions and long
chains of steps round in another order in XLA and PyTorch).
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.models.unet as ju
import sonar_tpu.samplers.sonar as js
from sonar_tpu.samplers.momentum import SonarConfig as JCfg
import sonar_tpu_torch.kernels.fused as TF
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.samplers.sonar as ts
from sonar_tpu_torch.models import UNetConfig, init_unet_params
from sonar_tpu_torch.noise import (NoiseCtx, NoiseSamplerHandle, get_noise_item,
                                   make_noise_sampler)
from sonar_tpu_torch.samplers.momentum import SonarConfig as TCfg

REL = 1e-4
REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden_trajectories.npz"


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _bench_sigmas(steps):
    """bench.py's headline schedule: Karras-style 14.6 → 0.03, then 0."""
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return np.concatenate([s, [0.0]]).astype(np.float32)


def _stub(lib, shape):
    """The golden-trajectory stub denoiser (tests/test_golden_trajectories.py)."""
    n = int(np.prod(shape))
    target = np.arange(n, dtype=np.float32).reshape(shape) / 100.0
    if lib == "jax":
        t = jnp.asarray(target)
        return lambda x, s, **_: (x * 0.9 + t) / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05)
    t = torch.from_numpy(target)
    return lambda x, s, **_: (x * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)


def _noise_stream(n_steps, shape, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n_steps)]


def _samplers(noises):
    """The same stream for both sides; JAX indexes it by the traced step."""
    stacked = jnp.asarray(np.stack(noises))
    return ((lambda i, s, sn: stacked[i]),
            (lambda i, s, sn: torch.from_numpy(noises[i])))


@pytest.mark.parametrize("use_fused_jax", [False, True])
def test_euler_ancestral_stub_matches_jax(use_fused_jax):
    """20 bench-schedule steps: the port's default route (kernel B1's
    wrapper, on the CPU its plain version) against JAX's composed and fused
    paths."""
    shape = (1, 4, 8, 8)
    sig = _bench_sigmas(20)
    x0 = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * sig[0]
    noises = _noise_stream(20, shape)
    jns, tns = _samplers(noises)
    ref = js.sample_sonar_euler_ancestral(_stub("jax", shape), jnp.asarray(x0),
                                          jnp.asarray(sig), noise_sampler=jns,
                                          use_fused=use_fused_jax)
    out = ts.sample_sonar_euler_ancestral(_stub("torch", shape), torch.from_numpy(x0),
                                          torch.from_numpy(sig), noise_sampler=tns)
    _close_rel(out.numpy(), ref)
    composed = ts.sample_sonar_euler_ancestral(
        _stub("torch", shape), torch.from_numpy(x0), torch.from_numpy(sig),
        noise_sampler=tns, use_fused=False)
    _close_rel(composed.numpy(), ref)


def test_euler_ancestral_unet_slice_matches_jax():
    """The slice as a whole: a narrow UNet through make_denoiser, the bench
    schedule cut to 6 steps, injected noise."""
    kw = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,),
              num_heads=2, norm_groups=4)
    jcfg = ju.UNetConfig(**kw)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**kw))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    shape, sig = (1, 4, 8, 8), _bench_sigmas(6)
    x0 = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * sig[0]
    jns, tns = _samplers(_noise_stream(6, shape))
    run = jax.jit(lambda x: js.sample_sonar_euler_ancestral(
        ju.make_denoiser(params, jcfg), x, jnp.asarray(sig), noise_sampler=jns))
    ref = run(jnp.asarray(x0))
    for use_fused in (None, False):
        out = ts.sample_sonar_euler_ancestral(
            tu.make_denoiser(model.eval()), torch.from_numpy(x0), torch.from_numpy(sig),
            noise_sampler=tns, use_fused=use_fused)
        _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("cfg_kw", [
    dict(init="sample", momentum_mode="classic"),
    dict(blend_mode="inject", momentum_start_step=2),
])
@pytest.mark.parametrize("eta,mode", [(1.0, "vp"), (0.7, "vp"), (1.0, "rf")])
def test_euler_ancestral_composed_configs_match_jax(cfg_kw, eta, mode):
    shape = (1, 4, 8, 8)
    sig = _bench_sigmas(6) if mode == "vp" else np.float32([1.0, 0.8, 0.5, 0.2, 0.0])
    x0 = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * sig[0]
    jns, tns = _samplers(_noise_stream(len(sig) - 1, shape))
    ref = js.sample_sonar_euler_ancestral(
        _stub("jax", shape), jnp.asarray(x0), jnp.asarray(sig), noise_sampler=jns,
        sonar_config=JCfg(**cfg_kw), eta=eta, s_noise=0.9, ancestral_mode=mode)
    out = ts.sample_sonar_euler_ancestral(
        _stub("torch", shape), torch.from_numpy(x0), torch.from_numpy(sig),
        noise_sampler=tns, sonar_config=TCfg(**cfg_kw), eta=eta, s_noise=0.9,
        ancestral_mode=mode)
    _close_rel(out.numpy(), ref)


@pytest.mark.skipif(not GOLDEN.exists(), reason="golden fixtures not generated")
def test_euler_reproduces_golden_fixture():
    shape = (1, 4, 8, 8)
    ramp = np.linspace(0, 1, 8)
    s = (10.0 ** (1 / 7.0) + ramp * (0.1 ** (1 / 7.0) - 10.0 ** (1 / 7.0))) ** 7.0
    sig = torch.tensor(np.concatenate([s, [0.0]]), dtype=torch.float32)
    x0 = torch.from_numpy(
        (np.random.default_rng(123).standard_normal(shape) * 10.0).astype(np.float32))
    cfg = TCfg(momentum=0.85, momentum_hist=0.7, direction=1.0)
    out = ts.sample_sonar_euler(_stub("torch", shape), x0, sig, sonar_config=cfg)
    _close_rel(out.numpy(), np.load(GOLDEN)["euler"])


@pytest.mark.parametrize("use_fused", [None, False])
@pytest.mark.parametrize("stop", [1, 3])
def test_stop_and_resume_is_bitwise(use_fused, stop):
    shape, sig = (1, 4, 8, 8), torch.from_numpy(_bench_sigmas(5))
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    model = _stub("torch", shape)
    full = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=11, use_fused=use_fused)
    _, carry = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=11, use_fused=use_fused,
                                               stop_step=stop, return_state=True)
    resumed = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=11, use_fused=use_fused,
                                              resume_from=carry, start_step=stop)
    assert torch.equal(full, resumed)
    other = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=12, use_fused=use_fused)
    assert not torch.equal(full, other)
    assert torch.equal(full, ts.sample_sonar_euler_ancestral(model, x0, sig, seed=11,
                                                             use_fused=use_fused))


def test_gaussian_noise_is_seeded_and_standard():
    shape = (1, 4, 64, 64)
    h1 = NoiseSamplerHandle(get_noise_item("gaussian"), shape, seed=3, device="cpu")
    h2 = NoiseSamplerHandle(get_noise_item("gaussian"), shape, seed=3, device="cpu")
    a, b = h1(1.0, 0.5), h2(1.0, 0.5)
    assert torch.equal(a, b) and a.shape == shape and a.dtype == torch.float32
    assert not torch.equal(a, h1(1.0, 0.5))  # the counter advances
    draws = torch.stack([h1() for _ in range(8)]).double()
    assert abs(float(draws.mean())) < 0.01
    assert abs(float(draws.std()) - 1.0) < 0.01
    kurt = float(((draws - draws.mean()) ** 4).mean() / draws.var() ** 2)
    assert abs(kurt - 3.0) < 0.1
    u = NoiseSamplerHandle(get_noise_item("uniform", normalize=False), shape, seed=3,
                           device="cpu")()
    assert -1.74 < float(u.min()) and float(u.max()) < 1.74
    with pytest.raises(ValueError, match="Unknown noise type"):
        get_noise_item("brownian_typo")


def test_default_noise_path_and_callback():
    shape, sig = (1, 4, 8, 8), torch.from_numpy(_bench_sigmas(4))
    x0 = torch.zeros(shape)
    seen = []
    n = TF.fused_momentum_step.launches
    out = ts.sample_sonar_euler_ancestral(_stub("torch", shape), x0, sig, seed=7,
                                          callback=seen.append)
    assert TF.fused_momentum_step.launches == n  # the CPU runs the plain version
    assert [d["i"] for d in seen] == [0, 1, 2, 3]
    assert seen[-1]["x"] is not None and torch.isfinite(out).all()
    bf = ts.sample_sonar_euler_ancestral(_stub("torch", shape), x0.bfloat16(), sig, seed=7)
    assert bf.dtype == torch.bfloat16
    assert ts._fused_eligible(TCfg()) and not ts._fused_eligible(TCfg(momentum=1.0))
    assert not ts._fused_eligible(TCfg(init="rand"))
    with pytest.raises(ValueError):
        ts.sample_sonar_euler_ancestral(_stub("torch", shape), x0, sig, use_fused=True,
                                        ancestral_mode="rf")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sonar_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sonar_tpu_torch.__path__, "
        "'sonar_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 45, names\n"
        "assert {'sonar_tpu_torch.api.pipeline', 'sonar_tpu_torch.cfg.wavelet_cfg',\n"
        "        'sonar_tpu_torch.wavelets.dwt'} <= set(names), names\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'sonar_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, names jax or the JAX
    package in an import statement."""
    import pathlib
    import re

    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|sonar_tpu)(?![\w])", re.M)
    files = sorted(pathlib.Path(REPO, "sonar_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(REPO, "chip_smoke.py"))
    assert len(files) >= 30
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


# ---------------------------------------------------------------------------
# the default device: the card, never the CPU
# ---------------------------------------------------------------------------


def _on_the_card_or_raises(make):
    """With a card ``make()`` gives CUDA tensors; without one it raises
    torch's own error at its first allocation (decided here, at run time)."""
    if torch.cuda.is_available():
        return make()
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
        make()
    return None


def test_default_device_is_the_card():
    from sonar_tpu_torch.noise.generators import _device
    from sonar_tpu_torch.utils.misc import default_device

    assert default_device() == default_device(None) == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert _device(NoiseCtx(shape=(1, 4, 8, 8))) == torch.device("cuda")
    assert _device(NoiseCtx(shape=(1, 4, 8, 8), device="cpu")) == torch.device("cpu")


@pytest.mark.parametrize("entry", ["make_noise_sampler", "NoiseSamplerHandle"])
@pytest.mark.parametrize("name", ["gaussian", "pyramid", "voronoi_mix"])
def test_noise_entry_points_default_to_the_card(entry, name):
    shape = (1, 4, 8, 8)

    def draw(**kw):
        if entry == "NoiseSamplerHandle":
            return NoiseSamplerHandle(get_noise_item(name), shape, seed=3, **kw)(1.0, 0.5)
        fn, st = make_noise_sampler(get_noise_item(name), shape, seed=3, **kw)
        return fn(st, 1.0, 0.5)[0]

    got = _on_the_card_or_raises(draw)
    assert got is None or (got.is_cuda and got.shape == shape)
    cpu = draw(device="cpu")
    assert cpu.device.type == "cpu" and torch.isfinite(cpu).all()
    assert torch.equal(cpu, draw(device=torch.device("cpu")))


def test_init_unet_params_defaults_to_the_card():
    cfg = UNetConfig(model_channels=16, channel_mult=(1, 2), attention_levels=(1,),
                     num_heads=2, norm_groups=4)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    model = _on_the_card_or_raises(lambda: init_unet_params(gen, cfg))
    if model is None:
        # it raised before drawing a weight: the generator has not moved
        assert torch.equal(gen.get_state(), before)
    else:
        assert all(p.is_cuda for p in model.parameters())
    cpu = init_unet_params(gen, cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in cpu.parameters())
