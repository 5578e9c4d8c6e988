"""The rest of the port's API layer against the JAX package, on the CPU:
the YAML loaders, the previews, extensions, and ``StepTimer``/``trace``.

- ``sonar_config_from_yaml`` and ``wcfg_rules_from_yaml`` build equal
  objects (``tests/_api_compare.same``); without PyYAML the package still
  imports and a YAML text raises an ``ImportError`` that names it.
- ``preview_power_filter`` and the filter and kernel panels of
  ``preview_power_noise``: within one ``uint8`` level of the JAX package's
  (float32 FFTs in another order can move a value across a level). The
  noise panel is drawn from another stream (Philox, not threefry): held by
  its statistics. ``noise_to_rgb`` is equal on one input.
- ``extensions``: registrations flow into node validation; ``discover``
  loads a module written to a temporary directory and reports and skips
  one that fails.
- ``StepTimer`` over a CPU sampler run, ``trace`` on the CPU.
"""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api as japi
import sonar_tpu.noise.power as JP
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.noise.power as TP
from _api_compare import same
from sonar_tpu_torch.api import extensions
from sonar_tpu_torch.noise import NoiseChain, get_noise_item, make_noise_sampler

SONAR_YAML = "momentum: 0.5\nmomentum_mode: classic\nblend_mode: slerp\ninit: rand\n"
WCFG_YAML = textwrap.dedent("""\
    wave: haar
    level: 2
    rules:
      - start_sigma: 3.0
        wave: db2
        diff: {yl_scale: 4.0, yh_scales: [3.0, 2.0]}
""")


# -- YAML ------------------------------------------------------------------------------


def test_sonar_config_from_yaml_equals_the_jax_package():
    want, got = japi.sonar_config_from_yaml(SONAR_YAML), tapi.sonar_config_from_yaml(SONAR_YAML)
    assert got.momentum == 0.5 and got.momentum_mode.value == "classic"
    same(want, got, "SonarConfig")
    same(japi.sonar_config_from_yaml(""), tapi.sonar_config_from_yaml(None), "empty")


def test_wcfg_rules_from_yaml_equal_the_jax_package():
    want = japi.wcfg_rules_from_yaml(WCFG_YAML, blend_strength=0.8)
    got = tapi.wcfg_rules_from_yaml(WCFG_YAML, blend_strength=0.8)
    assert len(got) == 2 and got[1].wavelet.wave == "db2"
    same(want, got, "WCFGRules")
    same(japi.wavelet_cfg_from_yaml(WCFG_YAML), tapi.wavelet_cfg_from_yaml(WCFG_YAML),
         "WaveletCFG")


@pytest.mark.parametrize("text", ["[1, 2]", "3"])
def test_yaml_parameters_must_be_a_mapping(text):
    with pytest.raises(ValueError, match="mapping"):
        japi.load_yaml_params(text)
    with pytest.raises(ValueError, match="mapping"):
        tapi.load_yaml_params(text)


def test_the_package_imports_without_pyyaml():
    code = textwrap.dedent("""\
        import sys
        sys.modules["yaml"] = None  # import yaml raises ImportError
        import sonar_tpu_torch.api as api
        assert api.load_yaml_params("") == {} and len(api.NODES) == 60
        chain = api.build("SonarCustomNoiseAdv", noise_type="gaussian")
        for call in (lambda: api.load_yaml_params("a: 1"),
                     lambda: api.build("SonarCustomNoiseAdv", yaml_parameters="alpha: 1"),
                     lambda: api.build("SonarWaveletCFG", yaml_parameters="wave: haar")):
            try:
                call()
            except ImportError as exc:
                assert "PyYAML" in str(exc), exc
            else:
                raise SystemExit("no ImportError")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# -- previews ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(alpha=0.5, min_freq=0.1),
                                dict(alpha=-0.3, max_freq=0.6, stretch=1.3, rotate=20.0),
                                dict(alpha=0.0, pnorm=1.0, rel_bw=0.2, oversample=2)])
@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_preview_power_filter_within_one_level(kw, size):
    want = japi.preview_power_filter(JP.PowerFilter(**kw), size=size, mix=0.8,
                                     normalization_factor=0.9)
    got = tapi.preview_power_filter(TP.PowerFilter(**kw), size=size, mix=0.8,
                                    normalization_factor=0.9)
    assert got.dtype == np.uint8 and got.shape == want.shape == (size[0], 2 * size[1])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_preview_power_noise_panels():
    kw = dict(alpha=0.5, min_freq=0.05)
    want = japi.preview_power_noise(JP.PowerNoiseItem(**kw), size=(32, 32), seed=3)
    got = tapi.preview_power_noise(TP.PowerNoiseItem(**kw), size=(32, 32), seed=3, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape == (32, 96)
    assert np.abs(got[:, :64].astype(int) - want[:, :64].astype(int)).max() <= 1
    a, b = want[:, 64:].astype(float), got[:, 64:].astype(float)
    assert abs(a.mean() - b.mean()) < 8 and abs(a.std() - b.std()) < 8
    assert b.std() > 10  # a noise panel, not a constant one


def test_noise_to_rgb_is_equal():
    rng = np.random.default_rng(0)
    for c in (1, 4):
        x = rng.standard_normal((2, c, 8, 6)).astype(np.float32) * 2
        want = japi.noise_to_rgb(jnp.asarray(x), gain=0.4)
        got = tapi.noise_to_rgb(torch.from_numpy(x), gain=0.4)
        assert got.dtype == np.uint8 and got.shape == (8, 6, 3)
        np.testing.assert_array_equal(got, want)


def test_preview_filter_node():
    img = tapi.build("SonarPreviewFilter", sonar_power_filter=TP.PowerFilter(alpha=0.5),
                     preview_size="384x256")
    want = japi.build("SonarPreviewFilter", sonar_power_filter=JP.PowerFilter(alpha=0.5),
                      preview_size="384x256")
    assert img.shape == (256, 768) and np.abs(img.astype(int) - want.astype(int)).max() <= 1


# -- extensions -------------------------------------------------------------------------


@pytest.fixture
def clean_registries():
    """Registrations are process-global: remove this file's afterwards."""
    yield
    from sonar_tpu_torch.core.blend import BLENDING_MODES
    from sonar_tpu_torch.core.normalize import QUANTILE_HANDLERS
    from sonar_tpu_torch.noise import blendfilter, presets

    for reg in (BLENDING_MODES, QUANTILE_HANDLERS, blendfilter.FILTER_PRESETS,
                blendfilter.ENHANCE_HANDLERS, presets.NOISE_TYPES):
        for k in [k for k in reg if str(k).startswith("testext_")]:
            del reg[k]


def _draw(item, shape=(1, 4, 8, 8)):
    fn, st = make_noise_sampler(item, shape, seed=0, device="cpu", sigma_min=0.03,
                                sigma_max=14.6)
    return fn(st, 1.0, 0.5)[0]


def test_registrations_flow_into_validation(clean_registries):
    gauss = NoiseChain([get_noise_item("gaussian")])
    extensions.register_blend_mode("testext_half", lambda a, b, t: (a + b) * t)
    extensions.register_ffilter_preset("testext_band", (0.0, 1.0, 0.0))
    extensions.register_enhance_mode("testext_negate", lambda t, scale, **kw: -t * scale)
    extensions.register_quantile_strategy("testext_zero", lambda noise, nq, **kw: noise * 0.0)
    from sonar_tpu_torch.noise.generators import GaussianGenerator

    extensions.register_noise_type("testext_gauss2", lambda factor=1.0, normalize=None, **kw:
                                   GaussianGenerator(factor, normalize=normalize, **kw))
    items = [
        tapi.build("SonarBlendedNoise", custom_noise_1=gauss,
                   custom_noise_2=NoiseChain([get_noise_item("uniform")]),
                   noise_2_percent=0.5, blend_mode="testext_half"),
        tapi.build("SonarBlendFilterNoise", sonar_custom_noise=gauss, ffilter="testext_band",
                   ffilter_strength=1.0, enhance_mode="testext_negate", enhance_strength=1.0),
        tapi.build("SonarCustomNoise", noise_type="testext_gauss2"),
    ]
    for item in items:
        assert torch.isfinite(_draw(item)).all()
    zero = tapi.build("SonarQuantileFilteredNoise", custom_noise=gauss, quantile=0.9,
                      strategy="testext_zero", normalize="disabled")
    assert not _draw(zero).any()
    with pytest.raises(ValueError, match="invalid"):
        japi.build("SonarCustomNoise", noise_type="testext_gauss2")  # the port's registry only


def test_discover_runs_hooks_and_skips_failures(tmp_path, monkeypatch, capsys, clean_registries):
    (tmp_path / "testext_good_ext.py").write_text(textwrap.dedent("""\
        CALLS = []

        def sonar_tpu_init(ext):
            CALLS.append(ext)
            ext.register_blend_mode("testext_from_module", lambda a, b, t: b)
    """))
    (tmp_path / "testext_bad_ext.py").write_text(
        "def sonar_tpu_init(ext):\n    raise RuntimeError('broken extension')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("SONAR_TPU_EXTENSIONS",
                       "testext_good_ext, testext_bad_ext, testext_not_installed_xyz")
    loaded = extensions.discover()
    assert loaded == ["testext_good_ext"]
    import testext_good_ext

    assert testext_good_ext.CALLS == [extensions]
    out = capsys.readouterr().out
    assert "testext_bad_ext" in out and "broken extension" in out
    assert "testext_not_installed_xyz" in out
    from sonar_tpu_torch.api.validate import validate_params

    validate_params("SonarBlendedNoise", {"blend_mode": "testext_from_module"})
    for name in ("testext_good_ext", "testext_bad_ext"):
        sys.modules.pop(name, None)


# -- StepTimer, trace -------------------------------------------------------------------


def _model(x, sigma, **kw):
    return x * 0.9


def test_step_timer_over_a_cpu_sampler_run():
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral
    from sonar_tpu_torch.utils import StepTimer

    timer = StepTimer()
    timer.start()
    sample_sonar_euler_ancestral(_model, torch.zeros(1, 4, 8, 8),
                                 torch.tensor([14.6, 7.0, 2.0, 0.5, 0.0]), seed=0,
                                 callback=timer)
    s = timer.summary()
    assert s["steps"] == 4 and s["p50_ms"] > 0 and s["p90_ms"] >= s["p50_ms"]
    assert s["steps_per_sec"] == pytest.approx(1e3 / s["mean_ms"])
    assert StepTimer().summary() == {"steps": 0}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import json

    from sonar_tpu_torch.utils import trace

    with trace(str(tmp_path / "t")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(open(path).read())["traceEvents"]
    assert path.endswith("trace.json") and any("mm" in e.get("name", "") for e in events)
