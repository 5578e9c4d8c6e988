"""The port's node builders (``sonar_tpu_torch.api.nodes``) against the JAX
package's, on the CPU.

- Both registries hold the same 60 names: the 54 reference nodes of
  ``tools/ref_schemas.json`` and six ComfyUI core or adapter names.
- Every node, built from its schema defaults and small link inputs (the
  same numpy values on both sides), builds an object of the counterpart
  class whose parameters are equal, compared field by field through the
  whole tree (arrays within 1e-6, functions by name, dtypes by name).
- The combinator nodes are drawn on shared base draws: their noise inputs
  are the stub leaves of ``_combinator_stubs`` (rows of one numpy table on
  both sides), their random choices one numpy stream; 1e-5 relative to
  max(1, |JAX|) a draw, 1e-4 where an FFT is on the path. The simple
  generator nodes are drawn on shared normals and uniforms (the stand-ins
  of ``tests/test_torch_noise_zoo.py``), 1e-5.
- ``SonarCustomNoiseParameters``' float64 override, ``SonarToComfyNOISE``'s
  batch_index gather order (on shared per-seed draws: Philox cannot
  reproduce threefry), and the cases of ``tests/test_api.py`` and
  ``tests/test_node_fixes.py`` that reach the node layer.
- The Sonar sampler nodes hand ``custom_noise_opt`` to
  ``SonarConfig.custom_noise``, as the reference does; the JAX package's
  builders drop it (held below on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api.functions as JF
import sonar_tpu.api.nodes as JN
import sonar_tpu.noise.base as JB
import sonar_tpu_torch.api.functions as TF
import sonar_tpu_torch.api.nodes as TN
import sonar_tpu_torch.noise.base as TB
from _api_compare import dtype_name, same
from _combinator_stubs import REL, REL_FFT, choices, run_both, stubs
from sonar_tpu.api.validate import ALIASES as J_ALIASES
from sonar_tpu.cfg.model_sampling import ContinuousEDM as JEDM
from sonar_tpu_torch.api.schemas import SCHEMAS
from sonar_tpu_torch.cfg.model_sampling import ContinuousEDM as TEDM
from sonar_tpu_torch.noise import NoiseChain, get_noise_item
from test_torch_noise_zoo import shared

__all__ = ["choices", "shared"]  # the fixtures, imported for pytest

ALIASES = {"SonarToComfyNOISE": "SONAR_CUSTOM_NOISE to NOISE"}
EXTRA_NAMES = {"BasicScheduler", "KarrasScheduler", "ExponentialScheduler",
               "PolyexponentialScheduler", "KSamplerSelect", "SonarToComfyNOISE"}
LATENT = np.random.default_rng(4).standard_normal((1, 4, 8, 8)).astype(np.float32)


# -- link inputs, the same values on both sides -----------------------------------------


def _links(side):
    """Factories of the link types: (JAX, port) objects of equal value."""
    import sonar_tpu.cfg.latent_ops as jlo
    import sonar_tpu.noise as jn
    import sonar_tpu.noise.power as jpw
    import sonar_tpu_torch.cfg.latent_ops as tlo
    import sonar_tpu_torch.noise.power as tpw

    j = side == "jax"
    arr = (lambda a: jnp.asarray(a)) if j else (lambda a: torch.from_numpy(np.asarray(a)))
    return {
        "OCS_NOISE,SONAR_CUSTOM_NOISE":
            lambda: (jn.NoiseChain([jn.get_noise_item("gaussian")]) if j
                     else NoiseChain([get_noise_item("gaussian")])),
        "SONAR_POWER_FILTER": lambda: (jpw.PowerFilter() if j else tpw.PowerFilter()),
        "LATENT": lambda: arr(LATENT),
        "MASK": lambda: arr(np.ones((8, 8), np.float32)),
        "IMAGE": lambda: arr(np.full((8, 8, 3), 0.5, np.float32)),
        "SIGMAS": lambda: arr(np.asarray([14.6, 7.0, 0.0], np.float32)),
        "LATENT_OPERATION": lambda: (jlo.SonarLatentOperation() if j
                                     else tlo.SonarLatentOperation()),
        "SAMPLER": lambda: "sonar_euler",
        "MODEL": lambda: None,
        "CONDITIONING": lambda: None,
        "FRUX_CONFIG": lambda: None,
        "SONAR_GUIDANCE_CFG": lambda: None,
    }


def _overrides(node, side):
    ms = JEDM() if side == "jax" else TEDM()
    return {
        "SonarScheduledNoise": {"model": ..., "model_sampling": ms},
        "SonarWaveletCFG": {"model": ...},
        "FreeUExtreme": {"model": ..., "model_sampling": ms, "model_channels": 320},
        "NoisyLatentLike": {"model_sampling": ms},
    }.get(node, {})


def _extra_params(node, side):
    """The six names without a reference schema."""
    chain = _links(side)["OCS_NOISE,SONAR_CUSTOM_NOISE"]
    return {"KSamplerSelect": {"sampler_name": "euler"},
            "SonarToComfyNOISE": {"sonar_custom_noise": chain(), "seed": 3},
            "BasicScheduler": {"model_sampling": JEDM() if side == "jax" else TEDM()},
            }.get(node, {})


def node_params(node, side, *, widgets=True):
    """Link inputs plus (with ``widgets``) every widget at its schema default."""
    if node in EXTRA_NAMES:
        return _extra_params(node, side)
    schema = SCHEMAS[ALIASES.get(node, node)]
    over = _overrides(node, side)
    links = _links(side)
    params = {}
    for fname, spec in schema.items():
        if fname in over:
            continue
        if spec["t"] == "x":
            made = links[spec["ty"]]()
            if made is not None:
                params[fname] = made
        elif widgets and spec.get("d") is not None:
            params[fname] = spec["d"]
    params.update({k: v for k, v in over.items() if v is not ...})
    return params


# -- shared draws for the nodes that draw at build time ---------------------------------


def _row(seed, shape, i):
    rng = np.random.default_rng([int(seed or 0), i, *shape])
    return (rng.standard_normal(shape) * 1.3 + 0.2).astype(np.float32)


@pytest.fixture
def per_seed(monkeypatch):
    """``make_noise_sampler`` on both sides, in ``api.functions`` and
    ``noise.base``, handing out numpy draws keyed by (seed, draw, shape);
    records the seeds asked for, in order."""
    asked = {"jax": [], "torch": []}

    def j_mns(item, shape, *, seed=None, dtype=jnp.float32, **_kw):
        asked["jax"].append(seed)
        shape = tuple(int(d) for d in shape)
        return (lambda st, s, sn: (jnp.asarray(_row(seed, shape, st), dtype), st + 1)), 0

    def t_mns(item, shape, *, seed=None, dtype=torch.float32, device=None, **_kw):
        asked["torch"].append(seed)
        shape = tuple(int(d) for d in shape)
        return (lambda st, s, sn: (torch.from_numpy(_row(seed, shape, st)).to(device, dtype),
                                   st + 1)), 0

    for mod, fn in ((JF, j_mns), (JB, j_mns), (TF, t_mns), (TB, t_mns)):
        monkeypatch.setattr(mod, "make_noise_sampler", fn)
    return asked


# -- the registry ----------------------------------------------------------------------


def test_registries_hold_the_same_60_names():
    assert set(TN.NODES) == set(JN.NODES)
    assert len(TN.NODES) == 60
    assert set(TN.NODES) == set(SCHEMAS) | EXTRA_NAMES
    assert J_ALIASES == ALIASES


# the JAX builder drops the sampler nodes' custom_noise_opt (see the module
# docstring): their configs differ in custom_noise alone, held apart below
CUSTOM_NOISE_NODES = {"SamplerSonarEuler", "SamplerSonarEulerA", "SamplerSonarDPMPPSDE"}


# where the JAX package's builder mishandles a widget's default (its draw then
# fails; see the tests below), the JAX side is given what the port makes of it
# (... drops the widget: the generator's own default)
JAX_EQUIVALENT = {
    "SonarAdvancedPowerLawNoise": {"div_max_dims": "all"},  # JAX's name of "non-batch"
    "SonarAdvancedVoronoiNoise": {"n_points": 256},
    "SonarAdvancedPyramidNoise": {"iterations": ..., "upscale_mode": ...},  # highres_pyramid
}


@pytest.mark.parametrize("node", sorted(JN.NODES))
def test_builds_equal_objects(node, per_seed):
    """NoisyLatentLike and SonarNoiseImage draw at build time: on shared
    per-seed draws."""
    jp, tp = node_params(node, "jax"), node_params(node, "torch")
    jp = {**jp, **JAX_EQUIVALENT.get(node, {})}
    for k in [k for k, v in jp.items() if v is ...]:
        del jp[k]
    want = JN.build(node, **jp)
    if "custom_noise_opt" in tp and node in CUSTOM_NOISE_NODES:
        cfg = _closure(TN.build(node, **tp))[1]["sonar_config"]
        assert isinstance(cfg.custom_noise, NoiseChain)
        del tp["custom_noise_opt"]  # what the JAX package's builder keeps
    same(want, TN.build(node, **tp), node)


def _closure(fn):
    return [c.cell_contents for c in fn.__closure__]


# -- combinator nodes on shared base draws ---------------------------------------------

SHAPE = (2, 4, 8, 8)
# node -> (widget overrides, relative tolerance)
NOISE_LINK = "OCS_NOISE,SONAR_CUSTOM_NOISE"
COMBINATOR_NODES = {
    "SonarModulatedNoise": ({}, REL_FFT),
    "SonarRepeatedNoise": ({"repeat_length": 3, "max_recycle": 2}, REL),
    "SonarScheduledNoise": ({"start_percent": 0.2, "end_percent": 0.7}, REL),
    "SonarCompositeNoise": ({}, REL),
    "SonarGuidedNoise": ({}, REL),
    "SonarRandomNoise": ({}, REL),
    "SonarChannelNoise": ({}, REL),
    "SonarBlendedNoise": ({}, REL),
    "SonarResizedNoise": ({"width": 96, "height": 80}, REL),
    "SonarResizedNoiseAdv": ({}, REL),
    "SonarQuantileFilteredNoise": ({}, REL),
    "SonarShuffledNoise": ({}, REL),
    "SonarPatternBreakNoise": ({}, REL),
    "SonarWaveletFilteredNoise": ({}, REL),
    "SonarScatternetFilteredNoise": ({}, REL),
    "SonarRippleFilteredNoise": ({}, REL),
    "SonarNormalizeNoiseToScale": ({}, REL),
    "SonarPerDimNoise": ({}, REL),
    "SonarLatentOperationFilteredNoise": ({}, REL),
    "SonarCustomNoiseParameters": ({}, REL),
    "SonarPowerFilterNoise": ({}, REL_FFT),
    "SonarBlendFilterNoise": ({"ffilter": "highpass",
                                                        "ffilter_strength": 0.5}, REL_FFT),
    "SonarBlehOpsNoise": ({}, REL),
    "SonarSplitNoiseChain": ({}, REL),
}


LIST_INPUT_NODES = {"SonarBlendFilterNoise", "SonarChannelNoise", "SonarRandomNoise"}


def test_the_combinator_sweep_covers_every_noise_input_node():
    noise_inputs = {n for n, spec in SCHEMAS.items()
                    if any(f.get("ty") == NOISE_LINK and f.get("r")
                           for f in spec.values())}
    samplers = {"SONAR_CUSTOM_NOISE to NOISE", "SonarLatentOperationNoise",
                "KRestartSamplerCustomNoise", "RestartSamplerCustomNoise"}
    assert noise_inputs - samplers <= set(COMBINATOR_NODES)


@pytest.mark.parametrize("node", sorted(COMBINATOR_NODES))
def test_combinator_nodes_draw_equal_on_shared_draws(node, choices):
    """Every noise input is a stub (tagged by its input's name); no upstream
    chain, whose gaussian would draw two streams."""
    import sonar_tpu.noise as jn

    widgets, rel = COMBINATOR_NODES[node]
    schema = SCHEMAS[node]
    inputs = sorted(f for f, spec in schema.items() if spec.get("ty") == NOISE_LINK
                    and f != "sonar_custom_noise_opt")
    jstubs, tstubs = stubs(*inputs)
    if node in LIST_INPUT_NODES:  # their noise input is a chain, iterated
        jstubs, tstubs = [jn.NoiseChain([v]) for v in jstubs], [NoiseChain([v]) for v in tstubs]
    jp = {**node_params(node, "jax"), **widgets, **dict(zip(inputs, jstubs))}
    tp = {**node_params(node, "torch"), **widgets, **dict(zip(inputs, tstubs))}
    for p in (jp, tp):
        p.pop("sonar_custom_noise_opt", None)
    run_both(JN.build(node, **jp), TN.build(node, **tp), SHAPE, n=2, rel=rel)


# the simple generators behind SonarCustomNoise and the 1f / power-law nodes
GENERATOR_CASES = [
    ("SonarCustomNoise", {"noise_type": "gaussian"}),
    ("SonarCustomNoise", {"noise_type": "uniform", "factor": 0.7}),
    ("SonarCustomNoise", {"noise_type": "perlin", "rescale": 1.0}),
    ("SonarCustomNoise", {"noise_type": "studentt"}),
    ("SonarCustomNoise", {"noise_type": "laplacian"}),
    ("SonarCustomNoiseAdv", {"noise_type": "onef_pinkish", "normalize": "forced"}),
    ("SonarAdvanced1fNoise", {}),
    ("SonarAdvancedPowerLawNoise", {"div_max_dims": "height"}),
]


@pytest.mark.parametrize("node,widgets", GENERATOR_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATOR_CASES)])
def test_generator_nodes_draw_equal_on_shared_draws(node, widgets, shared):
    jp = {**node_params(node, "jax"), **widgets}
    tp = {**node_params(node, "torch"), **widgets}
    jp.pop("sonar_custom_noise_opt")
    tp.pop("sonar_custom_noise_opt")
    run_both(JN.build(node, **jp), TN.build(node, **tp), SHAPE, n=2)
    jt, tt = shared
    assert tt.calls == jt.calls and tt.calls


@pytest.mark.parametrize("name,dims", [("none", None), ("non-batch", (-3, -2, -1)),
                                       ("spatial", (-2, -1))])
def test_power_law_node_maps_every_widget_name(name, dims, shared):
    """The reference widget's "none", "non-batch" (its default) and
    "spatial": the JAX package's map lacks them and its draw fails on the
    name; the port maps them (held on shared draws against the JAX generator
    given the dims)."""
    titem = TN.build("SonarAdvancedPowerLawNoise", div_max_dims=name)
    assert titem.items[0].div_max_dims == dims
    jitem = JN.build("SonarAdvancedPowerLawNoise", _validate=False, div_max_dims=dims)
    run_both(jitem, titem, SHAPE, n=1)
    broken = JN.build("SonarAdvancedPowerLawNoise", div_max_dims=name)
    with pytest.raises((ValueError, TypeError)):
        fn, st = JB.make_noise_sampler(broken, SHAPE, seed=1)
        fn(st, None, None)


@pytest.mark.parametrize("variant", ["highres_pyramid", "pyramid", "pyramid_old"])
def test_pyramid_node_reads_its_sentinels(variant, shared):
    """The widgets' defaults: iterations -1, discount 0, upscale_mode
    "default". The JAX package's highres_pyramid draw fails on -1 and every
    resize on "default": the port reads both as the variant's own and keeps
    the discount. Its pyramid and pyramid_old draw no level at -1 (the base
    alone; zeros): the port draws the same, held on shared draws."""
    tp = {**node_params("SonarAdvancedPyramidNoise", "torch"), "variant": variant}
    jp = {**node_params("SonarAdvancedPyramidNoise", "jax"), "variant": variant}
    tp.pop("sonar_custom_noise_opt")
    jp.pop("sonar_custom_noise_opt")
    gen, jgen = TN.build("SonarAdvancedPyramidNoise", **tp), JN.build("SonarAdvancedPyramidNoise", **jp)
    want = type(gen.items[0])(1.0)
    assert gen.items[0].upscale_mode == want.upscale_mode and gen.items[0].discount == 0.0
    if variant != "highres_pyramid":
        assert gen.items[0].iterations == jgen.items[0].iterations == -1
        run_both(jgen, gen, SHAPE, n=2)
        jt, tt = shared
        assert tt.calls == jt.calls
        return
    assert gen.items[0].iterations == want.iterations
    assert torch.isfinite(_draw(gen, (1, 4, 32, 32))).all()
    with pytest.raises(ValueError, match="negative dimensions"):
        fn, st = JB.make_noise_sampler(jgen, (1, 4, 32, 32), seed=1)
        fn(st, jnp.float32(1.0), jnp.float32(0.5))
    jgen = JN.build("SonarAdvancedPyramidNoise", **{**jp, "iterations": 3})
    with pytest.raises(ValueError, match="resize mode 'default'"):
        fn, st = JB.make_noise_sampler(jgen, (1, 4, 32, 32), seed=1)
        fn(st, jnp.float32(1.0), jnp.float32(0.5))


def test_voronoi_node_parses_its_string_widgets():
    """n_points "256" and comma-separated modes: the JAX package wraps a
    lone mode name but hands n_points' string on, and its draw fails."""
    got = TN.build("SonarAdvancedVoronoiNoise", n_points="32, 64", distance_mode="euclidean",
                   result_mode="f1, diff2").items[0]
    assert got.n_points == (32, 64) and got.result_mode == ("f1", "diff2")
    assert got.distance_mode == ("euclidean",)
    assert torch.isfinite(_draw(NoiseChain([got]))).all()
    jp = node_params("SonarAdvancedVoronoiNoise", "jax")
    jp.pop("sonar_custom_noise_opt")
    broken = JN.build("SonarAdvancedVoronoiNoise", **jp)  # n_points "256"
    with pytest.raises(TypeError):
        fn, st = JB.make_noise_sampler(broken, (1, 4, 8, 8), seed=1)
        fn(st, jnp.float32(1.0), jnp.float32(0.5))


def test_collatz_node_takes_a_dtype_name():
    """jnp takes a dtype's name; the port maps it (float64 to float32, as
    the JAX package draws it with 64-bit mode off)."""
    for name, want in (("float32", torch.float32), ("float64", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        gen = TN.build("SonarAdvancedCollatzNoise", noise_dtype=name).items[0]
        assert gen.noise_dtype == want
    assert torch.isfinite(_draw(TN.build("SonarAdvancedCollatzNoise"))).all()


# -- dtypes, the ComfyUI NOISE adapter, custom_noise_opt -------------------------------


@pytest.mark.parametrize("dtype", ["default", "float64", "bfloat16"])
def test_custom_noise_parameters_dtype_override(dtype):
    """"float64" draws float32 on both sides: 64-bit mode is off in the JAX
    package, and the card's kernels have no double instantiation."""
    import sonar_tpu.noise as jn

    jitem = JN.build("SonarCustomNoiseParameters", override_dtype=dtype,
                     custom_noise=jn.NoiseChain([jn.get_noise_item("gaussian")]))
    titem = TN.build("SonarCustomNoiseParameters", override_dtype=dtype,
                     custom_noise=NoiseChain([get_noise_item("gaussian")]))
    jfn, jst = JB.make_noise_sampler(jitem, SHAPE, seed=1)
    tfn, tst = TB.make_noise_sampler(titem, SHAPE, seed=1, device="cpu")
    want, got = jfn(jst, None, None)[0], tfn(tst, None, None)[0]
    assert dtype_name(want.dtype) == dtype_name(got.dtype) == "float32"
    child = {"default": None, "float32": torch.float32, "float64": torch.float32,
             "float16": torch.float16, "bfloat16": torch.bfloat16}[dtype]
    assert titem.items[0].override_dtype == child


def test_comfy_noise_adapter_gathers_in_the_same_order(per_seed):
    """batch_index [5, 0, 5, 2]: one draw per unique index (seed + index,
    on latent row index % batch), gathered back in inverse order."""
    latent = np.zeros((4, 4, 8, 8), np.float32)
    inds = [5, 0, 5, 2]
    j = JN.build("SonarToComfyNOISE", sonar_custom_noise=_links("jax")[
        "OCS_NOISE,SONAR_CUSTOM_NOISE"](), seed=3)
    t = TN.build("SonarToComfyNOISE", sonar_custom_noise=NoiseChain([get_noise_item("gaussian")]),
                 seed=3)
    want = j.generate_noise({"samples": jnp.asarray(latent), "batch_index": inds})
    got = t.generate_noise({"samples": torch.from_numpy(latent), "batch_index": inds})
    assert per_seed["torch"] == per_seed["jax"] == [3, 5, 8]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), got[2].numpy())
    assert got.device.type == "cpu"  # the input latent's device
    assert not torch.equal(got[0], got[1])
    zero = TN.build("SonarToComfyNOISE", sonar_custom_noise=NoiseChain(), multiplier=0.0)
    assert not zero.generate_noise(torch.ones(2, 4, 8, 8)).any()


def test_comfy_noise_adapter_draws_on_the_latents_device():
    adapter = TN.build("SONAR_CUSTOM_NOISE to NOISE",
                       custom_noise=NoiseChain([get_noise_item("gaussian")]), seed=5)
    out = adapter.generate_noise({"samples": torch.zeros(2, 4, 8, 8)})
    assert out.shape == (2, 4, 8, 8) and out.device.type == "cpu"
    assert abs(float(out.std()) - 1.0) < 0.2


@pytest.mark.parametrize("node", ["SamplerSonarEulerA", "SamplerSonarDPMPPSDE"])
def test_sonar_sampler_nodes_take_their_custom_noise(node):
    """custom_noise_opt becomes SonarConfig.custom_noise (the reference's
    precedence: custom noise before the noise sampler and the noise type);
    the JAX package's builder drops it."""
    chain = NoiseChain([get_noise_item("uniform")])
    sampler = TN.build(node, custom_noise_opt=chain)
    assert _closure(sampler)[1]["sonar_config"].custom_noise is chain
    jsampler = JN.build(node, custom_noise_opt=_links("jax")["OCS_NOISE,SONAR_CUSTOM_NOISE"]())
    assert _closure(jsampler)[1]["sonar_config"].custom_noise is None
    from sonar_tpu_torch.api.functions import get_sampler
    from sonar_tpu_torch.samplers.momentum import SonarConfig

    x0 = torch.from_numpy(LATENT) * 14.6
    sig = torch.tensor([14.6, 3.0, 0.5, 0.0])

    def model(x, s, **kw):
        return x / (1.0 + s.reshape(-1, 1, 1, 1))

    name = {"SamplerSonarEulerA": "sonar_euler_ancestral",
            "SamplerSonarDPMPPSDE": "sonar_dpmpp_sde"}[node]
    want = get_sampler(name)(model, x0, sig, seed=2, noise_item=chain,
                             sonar_config=SonarConfig())
    plain = get_sampler(name)(model, x0, sig, seed=2, sonar_config=SonarConfig())
    got = sampler(model, x0, sig, seed=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, plain)


# -- the node-layer cases of tests/test_api.py and tests/test_node_fixes.py -------------


def _draw(item, shape=(1, 4, 8, 8), seed=0):
    fn, state = TB.make_noise_sampler(item, shape, seed=seed, device="cpu", sigma_min=0.03,
                                      sigma_max=14.6)
    return fn(state, 1.0, 0.5)[0]


def test_chain_semantics():
    c1 = TN.build("SonarCustomNoise", factor=1.0, noise_type="gaussian")
    c2 = TN.build("SonarCustomNoise", factor=2.0, noise_type="uniform", sonar_custom_noise_opt=c1)
    assert isinstance(c2, NoiseChain) and len(c2.items) == 2 and len(c1.items) == 1
    c3 = TN.build("SonarCustomNoise", factor=0.0, noise_type="uniform", sonar_custom_noise_opt=c1)
    assert len(c3.items) == 1
    c4 = TN.build("SonarCustomNoise", factor=3.0, noise_type="uniform", rescale=1.0,
                  sonar_custom_noise_opt=c1)
    assert c4.chain_factor == pytest.approx(1.0)


def test_node_built_tree_samples():
    from sonar_tpu_torch.cfg import DiscreteSampling

    gauss = TN.build("SonarCustomNoise", factor=1.0, noise_type="gaussian")
    sched = TN.build("SonarScheduledNoise", factor=1.0, model_sampling=DiscreteSampling(),
                     sonar_custom_noise=gauss, start_percent=0.0, end_percent=0.8,
                     normalize="default", fallback_sonar_custom_noise=gauss)
    fn, st = TB.make_noise_sampler(sched, (1, 4, 8, 8), seed=0, device="cpu")
    assert torch.isfinite(fn(st, 5.0, 4.0)[0]).all()


def test_sampler_nodes_build_callables():
    assert callable(TN.build("SamplerSonarEulerA", momentum=0.9, momentum_hist=0.7, eta=0.8))
    assert callable(TN.build("SamplerConfigOverride", sampler="sonar_dpmpp_sde", s_noise=0.9))
    assert callable(TN.build("RestartSamplerCustomNoise", custom_noise=get_noise_item("gaussian")))


def test_noisy_latent_like_node_custom_noise_passthrough():
    chain = TN.build("SonarCustomNoise", factor=1.0, noise_type="pyramid")
    latent = torch.zeros(1, 4, 16, 16)
    a = TN.build("NoisyLatentLike", latent=latent, seed=0, custom_noise_opt=chain)
    b = TN.build("NoisyLatentLike", latent=latent, seed=0)

    def lowfreq_share(t):
        spec = torch.fft.rfft2(t).abs()
        return float(spec[..., :3, :3].sum() / spec.sum())

    assert a.device.type == "cpu" and lowfreq_share(a) > lowfreq_share(b) * 1.5


def test_blend_filter_node_boosts_high_frequencies():
    chain = NoiseChain([get_noise_item("gaussian"), get_noise_item("uniform", factor=0.5)])
    item = TN.build("SonarBlendFilterNoise", factor=1.0, sonar_custom_noise=chain,
                    ffilter="highpass", ffilter_strength=0.8, enhance_mode="sharpen",
                    enhance_strength=0.3, affect="both")
    plain = TN.build("SonarBlendFilterNoise", factor=1.0, sonar_custom_noise=chain,
                     affect="result")

    def hf_share(t):
        spec = torch.fft.rfft2(t).abs()
        return float(spec[..., 6:, 6:].sum() / spec.sum())

    assert hf_share(_draw(item, (1, 4, 16, 16))) > hf_share(_draw(plain, (1, 4, 16, 16)))


def test_bleh_ops_node_rejects_an_unknown_op():
    chain = NoiseChain([get_noise_item("gaussian")])
    with pytest.raises(ValueError, match="Unknown op"):
        TN.build("SonarBlehOpsNoise", factor=1.0, sonar_custom_noise=chain,
                 rules="- ops: [[nosuch, 1]]")


def test_split_noise_chain_node_semantics():
    from sonar_tpu_torch.noise import BlendedNoise

    inner = TN.build("SonarCustomNoise", factor=1.0, noise_type="gaussian")
    inner = TN.build("SonarCustomNoise", factor=0.5, noise_type="uniform",
                     sonar_custom_noise_opt=inner)
    chain = TN.build("SonarSplitNoiseChain", custom_noise=inner)
    assert len(chain.items) == 1 and isinstance(chain.items[0], BlendedNoise)
    expected = NoiseChain([BlendedNoise(1.0, blend_function=lambda a, _b, _t: a,
                                        custom_noise_1=inner.clone(), custom_noise_2=None,
                                        noise_2_percent=0.0)])
    torch.testing.assert_close(_draw(chain), _draw(expected), rtol=1e-6, atol=0)
    assert len(TN.build("SonarSplitNoiseChain", factor=0.0, custom_noise=inner).items) == 0
    base = TN.build("SonarCustomNoise", factor=1.0, noise_type="gaussian")
    assert len(TN.build("SonarSplitNoiseChain", custom_noise=inner,
                        sonar_custom_noise_opt=base).items) == 2


def test_channel_noise_accepts_mix_count():
    inner = TN.build("SonarCustomNoise", factor=1.0, noise_type="gaussian")
    assert _draw(TN.build("SonarChannelNoise", sonar_custom_noise=inner,
                          mix_count=3)).shape == (1, 4, 8, 8)


def test_tensor_nodes_follow_their_tensors_and_default_to_the_card(monkeypatch):
    """A CPU tensor stays on the CPU; a numpy input goes to the card, never
    silently to the CPU (here: the default device, recorded)."""
    img = torch.full((1, 16, 16, 3), 0.5)
    out = TN.build("SonarNoiseImage", image=img, seed=0, noise_multiplier=0.3)
    assert out.device.type == "cpu" and out.shape == img.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    asked = []
    monkeypatch.setattr(TN, "default_device", lambda device=None: asked.append(device) or
                        torch.device("cpu"))
    got = TN.build("SonarGuidedNoise", latent=LATENT.astype(np.float64))
    assert asked == [None]
    assert got.items[0].ref_latent.dtype == torch.float32
