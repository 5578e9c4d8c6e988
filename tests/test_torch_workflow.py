"""ComfyUI workflow porting in the port (``sonar_tpu_torch.api.workflow``)
against the JAX package's, on the CPU, on graphs written here (the
reference corpus of ``tests/test_workflow_port.py`` is not in the
repository).

- The inline graphs of ``tests/test_workflow_port.py`` and the two graphs
  that ``chip_smoke.py`` [27] runs on the card: (a) BASELINE config 2 as a
  workflow (perlin 0.6 chained with onef_pinkish 0.4 into
  SamplerSonarEulerA at momentum 0.95, host SamplerCustom at cfg 7, seed
  7) and (b) a kernel-heavy graph (pyramid into Voronoi into
  SamplerSonarEulerA, wavelet CFG at its widget defaults, KarrasScheduler).
  ``PortResult``'s fields are equal: the built objects field by field
  (``tests/_api_compare.same``), ``classes``, ``skipped``, ``failed``,
  ``consumed``, ``warnings`` (text included) and ``host_sampler``.
- One difference on purpose: the Sonar sampler nodes pass
  ``custom_noise_opt`` to ``SonarConfig.custom_noise`` in the port, as the
  reference does; the JAX package's builder drops it. The pipelines of (a)
  and (b) are held on one injected numpy noise stream: each sampler's
  ``make_noise_sampler`` is replaced on both sides by one that hands out
  the stream's rows in call order and records the item it was given (the
  port's: the workflow's chain; the JAX package's: its gaussian default).
  Narrow UNet (16 channels, mult (1, 2)), weights carried across by
  ``unet_params_from_jax``, 1×4×32×32, 4 steps; 1e-4 relative to the
  trajectory's largest magnitude, the trajectory limit of PERF.md §2.
- ``read_png_metadata`` reads back a PNG the test writes (tEXt, zTXt and
  iTXt chunks).
"""

import dataclasses
import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api as japi
import sonar_tpu.cfg as jc
import sonar_tpu.models.unet as ju
import sonar_tpu.samplers.sonar as JS
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.cfg as tc
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.samplers.sonar as TS
from _api_compare import same
from sonar_tpu.api.workflow import read_png_metadata as j_read_png
from sonar_tpu_torch.api.schemas import SCHEMAS
from sonar_tpu_torch.api.workflow import read_png_metadata

REL = 1e-4
SHAPE = (1, 4, 32, 32)
STEPS = 4
UNET_KW = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,), num_heads=2,
               norm_groups=4)
SAMPLER_NODES = {"SamplerSonarEuler", "SamplerSonarEulerA", "SamplerSonarDPMPPSDE"}


def _widgets(node, **over):
    """Every widget of ``node`` at its schema default, as ComfyUI stores
    them, then ``over``."""
    return {**{f: s["d"] for f, s in SCHEMAS[node].items()
               if s["t"] != "x" and s.get("d") is not None}, **over}


def graph_a():
    """BASELINE config 2 (tools/bench_configs.py:33-49) as a ComfyUI graph."""
    return {
        "1": {"class_type": "SonarCustomNoise",
              "inputs": {"factor": 0.6, "rescale": 0.0, "noise_type": "perlin"}},
        "2": {"class_type": "SonarCustomNoise",
              "inputs": {"factor": 0.4, "rescale": 0.0, "noise_type": "onef_pinkish",
                         "sonar_custom_noise_opt": ["1", 0]}},
        "3": {"class_type": "SamplerSonarEulerA",
              "inputs": _widgets("SamplerSonarEulerA", momentum=0.95,
                                 custom_noise_opt=["2", 0])},
        "4": {"class_type": "SamplerCustom",
              "inputs": {"add_noise": True, "noise_seed": 7, "cfg": 7.0, "sampler": ["3", 0]}},
    }


def graph_b(steps=20):
    """Pyramid (variant "pyramid", the upscale ladder, with its levels set:
    at iterations -1 it draws the base alone) then Voronoi, chained into
    SamplerSonarEulerA, wavelet CFG at its widget defaults (no YAML), Karras
    sigmas."""
    return {
        "1": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": "model.ckpt"}},
        "2": {"class_type": "SonarAdvancedPyramidNoise",
              "inputs": _widgets("SonarAdvancedPyramidNoise", factor=0.5, variant="pyramid",
                                 iterations=8, discount=0.7, upscale_mode="bilinear")},
        "3": {"class_type": "SonarAdvancedVoronoiNoise",
              "inputs": _widgets("SonarAdvancedVoronoiNoise", factor=0.5,
                                 sonar_custom_noise_opt=["2", 0])},
        "4": {"class_type": "SamplerSonarEulerA",
              "inputs": _widgets("SamplerSonarEulerA", custom_noise_opt=["3", 0])},
        "5": {"class_type": "SonarWaveletCFG",
              "inputs": {k: v for k, v in _widgets("SonarWaveletCFG", model=["1", 0]).items()
                         if k != "yaml_parameters"}},
        "6": {"class_type": "KarrasScheduler",
              "inputs": {"steps": steps, "sigma_max": 14.6, "sigma_min": 0.03, "rho": 7.0}},
        "7": {"class_type": "SamplerCustom",
              "inputs": {"model": ["5", 0], "add_noise": True, "noise_seed": 7, "cfg": 7.0,
                         "sampler": ["4", 0], "sigmas": ["6", 0]}},
    }


def _closure(fn):
    return [c.cell_contents for c in fn.__closure__]


# the widget defaults on which the JAX package's draws fail, read by the port
# as the reference reads them (tests/test_torch_nodes.py holds both sides)
SKIP = {"VoronoiGenerator": {"n_points"}}


def same_result(jres, tres, graph):
    """Every field of the two PortResults; the Sonar sampler nodes' configs
    differ in ``custom_noise`` alone (the port's is the linked chain), and
    ``SKIP``'s widgets are not compared."""
    assert tres.classes == jres.classes
    assert tres.skipped == jres.skipped
    assert tres.failed == jres.failed
    assert tres.consumed == jres.consumed
    assert tres.warnings == jres.warnings
    assert tres.host_sampler == jres.host_sampler
    assert set(tres.built) == set(jres.built)
    for nid, obj in jres.built.items():
        got = tres.built[nid]
        if tres.classes[nid] in SAMPLER_NODES:
            (fn_j, kept_j), (fn_t, kept_t) = _closure(obj), _closure(got)
            assert fn_t.__name__ == fn_j.__name__
            cfg = kept_t["sonar_config"]
            if "custom_noise_opt" in graph[nid]["inputs"]:
                assert cfg.custom_noise is tres.built[graph[nid]["inputs"]["custom_noise_opt"][0]]
            got = {**kept_t, "sonar_config": dataclasses.replace(cfg, custom_noise=None)}
            obj = kept_j
        same(obj, got, nid, skip=SKIP)


def _port(g, *, jexternals=None, texternals=None):
    return (japi.port_workflow(g, externals=jexternals),
            tapi.port_workflow(g, externals=texternals))


# -- the inline graphs of tests/test_workflow_port.py ------------------------------------


def test_read_workflow_accepts_json_string_and_dict():
    g = {"1": {"class_type": "SonarCustomNoise",
               "inputs": {"factor": 1.0, "rescale": 0.0, "noise_type": "gaussian"}}}
    assert tapi.read_workflow(json.dumps(g)) == g
    jres, tres = japi.port_workflow(g), tapi.port_workflow(g)
    assert list(tres.noise_roots) == list(jres.noise_roots) == ["1"]
    same_result(jres, tres, g)


def _toy_models():
    def j_model(x, sb, **kw):
        return x / (1.0 + sb.reshape(-1, 1, 1, 1))

    def t_model(x, sb, **kw):
        return x / (1.0 + sb.reshape(-1, 1, 1, 1))

    return j_model, t_model


def test_ksampler_select_feeding_override_is_consumed():
    g = {
        "1": {"class_type": "KSamplerSelect", "inputs": {"sampler_name": "dpmpp_2s_ancestral"}},
        "2": {"class_type": "SamplerConfigOverride",
              "inputs": {"sampler": ["1", 0], "eta": 0.5, "noise_type": "pyramid"}},
    }
    jm, tm = _toy_models()
    jpipe, jres = japi.pipeline_from_workflow(g, model=jm, cfg_scale=1.0)
    tpipe, tres = tapi.pipeline_from_workflow(g, model=tm, cfg_scale=1.0)
    same_result(jres, tres, g)
    assert "override" in tpipe.sampler.__name__ and "1" in tres.consumed
    out = tpipe(torch.ones(1, 4, 16, 16) * 14.6, torch.tensor([14.6, 3.0, 0.5, 0.0]))
    assert torch.isfinite(out).all()


def test_host_invoker_config_harvested():
    from sonar_tpu_torch.api.functions import SAMPLERS

    g = {
        "1": {"class_type": "SonarCustomNoise",
              "inputs": {"noise_type": "pyramid", "factor": 1.0, "rescale": 0.0}},
        "9": {"class_type": "KSamplerAdvanced",
              "inputs": {"cfg": 6.5, "noise_seed": 1234, "sampler_name": "dpmpp_2m_sde",
                         "scheduler": "karras", "steps": 12, "add_noise": "enable",
                         "start_at_step": 0, "end_at_step": 10000, "model": ["99", 0]}},
    }
    jm, tm = _toy_models()
    jpipe, jres = japi.pipeline_from_workflow(g, model=jm)
    tpipe, tres = tapi.pipeline_from_workflow(g, model=tm)
    same_result(jres, tres, g)
    assert tpipe.cfg_scale == 6.5 and tpipe.seed == 1234
    assert tpipe.sampler is SAMPLERS["dpmpp_2m_sde"]
    same(jres.host_sigmas(jc.DiscreteSampling()), tres.host_sigmas(tc.DiscreteSampling()))
    sig = tres.host_sigmas(tc.DiscreteSampling())
    assert sig.shape[0] == 13 and float(sig[-1]) == 0.0
    out = tpipe(torch.ones(1, 4, 16, 16) * float(sig[0]), sig)
    assert torch.isfinite(out).all()
    tpipe2, _ = tapi.pipeline_from_workflow(g, model=tm, cfg_scale=2.0, seed=7)
    assert tpipe2.cfg_scale == 2.0 and tpipe2.seed == 7


def test_pipeline_wires_latent_op_cfg_and_sampler_node_errors():
    g = {
        "1": {"class_type": "SonarLatentOperationAdvanced",
              "inputs": {"input_multiplier": 1.0, "output_multiplier": 1.0,
                         "difference_multiplier": 1.0}},
        "2": {"class_type": "SonarApplyLatentOperationCFG",
              "inputs": {"operation": ["1", 0], "mode": "denoised"}},
        "3": "top-level junk the parser must tolerate",
    }
    jm, tm = _toy_models()
    _, jres = japi.pipeline_from_workflow(g, model=jm)
    tpipe, tres = tapi.pipeline_from_workflow(g, model=tm)
    same_result(jres, tres, g)
    assert tpipe.latent_op_cfg is not None
    with pytest.raises(ValueError, match="built sampler nodes") as t:
        tapi.pipeline_from_workflow(g, model=tm, sampler_node="1")
    with pytest.raises(ValueError) as j:
        japi.pipeline_from_workflow(g, model=jm, sampler_node="1")
    assert str(t.value) == str(j.value)


def test_failures_warnings_and_externals(monkeypatch):
    """A missing required host input fails with the same actionable text; a
    legacy noise type and a dropped optional host input warn alike; a numpy
    external becomes a float32 tensor on the default device (the CPU here),
    once."""
    import sonar_tpu_torch.api.nodes as TN

    monkeypatch.setattr(TN, "default_device", lambda device=None: torch.device("cpu"))
    g = {
        "1": {"class_type": "EmptyLatentImage", "inputs": {"width": 64, "height": 64}},
        "2": {"class_type": "SonarCustomNoise",
              "inputs": {"factor": 1.0, "rescale": 0.0, "noise_type": "pink"}},
        "3": {"class_type": "SonarGuidedNoise",
              "inputs": {"latent": ["1", 0], "sonar_custom_noise": ["2", 0]}},
        "4": {"class_type": "SonarCompositeNoise",
              "inputs": {"sonar_custom_noise_dst": ["2", 0], "sonar_custom_noise_src": ["2", 0],
                         "mask": ["1", 0]}},
        "5": {"class_type": "NoisyLatentLike",
              "inputs": {"latent": ["1", 0], "seed": 3, "mul_by_sigmas_opt": ["1", 0]}},
    }
    latent = np.random.default_rng(0).standard_normal((1, 4, 8, 8))  # float64
    jres, tres = _port(g, jexternals={"3.latent": jnp.asarray(latent, jnp.float32)},
                       texternals={"3.latent": latent})
    assert set(tres.failed) == {"4", "5"} and "externals" in tres.failed["4"]
    assert any("legacy noise type" in w for w in tres.warnings)
    same_result(jres, tres, g)
    ref = tres.built["3"].items[0].ref_latent
    assert ref.dtype == torch.float32 and ref.device.type == "cpu"


def test_numpy_externals_go_to_the_card_by_default(monkeypatch):
    import sonar_tpu_torch.api.nodes as TN

    asked = []
    monkeypatch.setattr(TN, "default_device", lambda device=None: asked.append(device)
                        or torch.device("cpu"))
    g = {"1": {"class_type": "SonarGuidedNoise", "inputs": {"latent": ["9", 0]}},
         "9": {"class_type": "VAEEncode", "inputs": {}}}
    res = tapi.port_workflow(g, externals={"latent": np.zeros((1, 4, 8, 8), np.float32)})
    assert asked == [None] and not res.failed


# -- graphs (a) and (b) at a narrow UNet -----------------------------------------------


@pytest.fixture(scope="module")
def unets():
    jcfg = ju.UNetConfig(**UNET_KW)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    return jcfg, params, model.eval()


def _pair(unets):
    """bench.py:413-422's cond/uncond pair (the uncond UNet sees x·c_in·0.97)."""
    jcfg, params, model = unets

    def j_den(scale):
        def den(x, sb, **_):
            s = sb.reshape(-1, 1, 1, 1)
            return x - s * ju.unet_apply(params, x / jnp.sqrt(1 + s**2) * scale, sb, jcfg)
        return den

    def t_den(scale):
        @torch.no_grad()
        def den(x, sb, **_):
            s = sb.reshape(-1, 1, 1, 1)
            return x - s * model(x / torch.sqrt(1 + s**2) * scale, sb)
        return den

    return (j_den(1.0), j_den(0.97)), (t_den(1.0), t_den(0.97))


@pytest.fixture
def injected(monkeypatch):
    """Both Sonar samplers' noise from one numpy stream, in call order;
    records the item each was handed."""
    rows = np.random.default_rng(5).standard_normal((2 * STEPS + 2,) + SHAPE).astype(np.float32)
    items = {"jax": [], "torch": []}

    def j_mns(item, shape, **_kw):
        items["jax"].append(item)
        table = jnp.asarray(rows)
        return (lambda st, s, sn: (table[st], st + 1)), jnp.int32(0)

    def t_mns(item, shape, *, device=None, **_kw):
        items["torch"].append(item)
        return (lambda st, s, sn: (torch.from_numpy(rows[st]).to(device), st + 1)), 0

    monkeypatch.setattr(JS, "make_noise_sampler", j_mns)
    monkeypatch.setattr(TS, "make_noise_sampler", t_mns)
    return items


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("which", ["a", "b"])
def test_workflow_pipelines_match_jax(unets, injected, which):
    g = graph_a() if which == "a" else graph_b(steps=STEPS)
    (jcond, juncond), (tcond, tuncond) = _pair(unets)
    jpipe, jres = japi.pipeline_from_workflow(g, model=jcond, model_uncond=juncond,
                                              model_sampling=jc.DiscreteSampling())
    tpipe, tres = tapi.pipeline_from_workflow(g, model=tcond, model_uncond=tuncond,
                                              model_sampling=tc.DiscreteSampling())
    same_result(jres, tres, g)
    assert tpipe.cfg_scale == jpipe.cfg_scale == 7.0 and tpipe.seed == jpipe.seed == 7
    assert (tpipe.wavelet_cfg is None) == (jpipe.wavelet_cfg is None) == (which == "a")
    if which == "a":
        ramp = np.linspace(0, 1, STEPS)
        sig = np.concatenate([(14.6 ** (1 / 7) + ramp * (0.03 ** (1 / 7) - 14.6 ** (1 / 7)))
                              ** 7, [0.0]]).astype(np.float32)
    else:
        same(jres.sigmas, tres.sigmas, "sigmas")
        sig = tres.sigmas.numpy()
    x0 = (np.random.default_rng(1).standard_normal(SHAPE) * sig[0]).astype(np.float32)
    want = jax.jit(lambda x: jpipe(x, sig))(jnp.asarray(x0))
    got = tpipe(torch.from_numpy(x0), sig)
    assert got.shape == SHAPE and got.dtype == torch.float32
    _close_rel(got, want)
    # the port's sampler drew from the workflow's chain, the JAX package's
    # from its gaussian default (its builder dropped custom_noise_opt)
    (t_item,), (j_item,) = injected["torch"], injected["jax"]
    consumed_chain = tres.built["2" if which == "a" else "3"]
    assert t_item is consumed_chain
    assert type(j_item).__name__ == "GaussianGenerator"


# -- PNG metadata ----------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def test_read_png_metadata_from_a_written_png(tmp_path):
    g = graph_a()
    ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 0)
    png = b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", ihdr),
        _chunk(b"tEXt", b"prompt\x00" + json.dumps(g).encode("latin-1")),
        _chunk(b"zTXt", b"note\x00\x00" + zlib.compress(b"compressed text")),
        _chunk(b"iTXt", b"workflow\x00\x01\x00en\x00Workflow\x00"
               + zlib.compress(json.dumps({"nodes": []}).encode())),
        _chunk(b"IDAT", zlib.compress(b"\x00\x00")),
        _chunk(b"IEND", b""),
    ])
    path = tmp_path / "graph.png"
    path.write_bytes(png)
    meta = read_png_metadata(path)
    assert meta == j_read_png(path)
    assert meta["note"] == "compressed text" and json.loads(meta["workflow"]) == {"nodes": []}
    assert tapi.read_workflow(str(path)) == g
    (tmp_path / "plain.png").write_bytes(png.replace(b"tEXt", b"tEXx"))
    with pytest.raises(ValueError, match="no embedded ComfyUI prompt"):
        tapi.read_workflow(str(tmp_path / "plain.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_metadata(tmp_path / "not.png")
