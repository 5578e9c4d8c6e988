"""The port's BlendFilterNoise, its frequency filter and enhancements, and
the ops rule engine (BlehOpsNoise) against the JAX package's, on the CPU;
then the helpers the combinator algebra stands on (``utils.misc``,
``normalize_to_scale_adv``, ``prepare_ref_latent(strict_reference_compat=)``,
``NoiseCtx.ref_like``) at 1e-6, config 5's Voronoi z-walk cell at
1×4×4×32×32 on shared feature points, and ``chip_smoke.py`` [25]'s tree C
over a 6-step schedule.

``ffilter`` and ``enhance_tensor`` take the same numpy input on both sides;
the noise items run over stub children that hand out rows of one numpy
table, or over leaves whose draws are shared numpy normals
(``tests/_combinator_stubs.py``). Tolerance 1e-5 relative to
max(1, |JAX|): FFTs and sums in another order.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.blendfilter as JB
import sonar_tpu.noise.combinators as JC
import sonar_tpu.noise.ops_engine as JO
import sonar_tpu_torch.noise.blendfilter as TB
import sonar_tpu_torch.noise.combinators as TC
import sonar_tpu_torch.noise.ops_engine as TO
from _combinator_stubs import choices, close_rel, exemplar, run_both, stubs

__all__ = ["choices"]  # the fixture, imported for pytest

X = np.random.default_rng(7).standard_normal((2, 4, 12, 10)).astype(np.float32) * 1.3 + 0.2


@pytest.mark.parametrize("filt", sorted(JB.FILTER_PRESETS) + [[0.2, 1.0, 0.5], [1.5]])
@pytest.mark.parametrize("threshold,scale,strength", [(0.0, 1.0, 1.0), (0.4, 0.25, 0.6)])
def test_ffilter(filt, threshold, scale, strength):
    want = JB.ffilter(jnp.asarray(X), threshold, scale, filt, strength)
    got = TB.ffilter(torch.from_numpy(X), threshold, scale, filt, strength)
    close_rel(got, want)


def test_ffilter_unknown_preset():
    with pytest.raises(ValueError, match="Unknown ffilter"):
        TB.ffilter(torch.from_numpy(X), 0.0, 1.0, "nope", 1.0)


@pytest.mark.parametrize("mode", ["none", *sorted(JB.ENHANCE_HANDLERS)])
@pytest.mark.parametrize("scale", [0.3, -1.2])
def test_enhance_tensor(mode, scale):
    want = JB.enhance_tensor(jnp.asarray(X), mode, scale)
    got = TB.enhance_tensor(torch.from_numpy(X), mode, scale)
    close_rel(got, want)


@pytest.mark.parametrize("shape", [(1, 1, 3, 9), (2, 3, 1, 5), (1, 2, 2, 2)])
def test_sep_blur_narrow_axes(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    close_rel(TB._sep_blur(torch.from_numpy(x), 1.5), JB._sep_blur(jnp.asarray(x), 1.5))


@pytest.mark.parametrize("kw", [
    {},
    {"ffilter": "highpass", "enhance_mode": "sharpen", "affect": "both"},
    {"ffilter": [0.0, 1.0, 1.0], "ffilter_threshold": 0.3, "ffilter_scale": 0.5,
     "affect": "noise", "blend_mode": "lerp"},
    {"enhance_mode": "contrast", "enhance_strength": 0.5, "normalize_noise": False,
     "normalize_result": True},
])
def test_blend_filter_noise(kw):
    js, ts = stubs("bf0", "bf1", "bf2")
    js[1].factor = ts[1].factor = 0.5
    run_both(JB.BlendFilterNoise(noise=js, **kw), TB.BlendFilterNoise(noise=ts, **kw),
             (2, 4, 12, 10), n=3)


PROGRAM = [
    {"when": {"sigma_min": 1.0, "sigma_max": 9.0},
     "ops": [["multiply", 1.5], ["add", 0.1], ["ffilter", {"filter": "highpass", "strength": 0.7}],
             ["enhance", {"mode": "sharpen", "scale": 0.3}], ["roll", {"dim": -1, "amount": 3}],
             ["flip", {"dim": -2}]]},
    {"ops": [["blend", {"mode": "lerp", "strength": 0.25, "source": "hsp"}], "abs", "neg",
             ["quantile", {"quantile": 0.8, "strategy": "tanh"}], ["normalize", {"factor": 1.2}]]},
    {"when": {"sigma_max": 0.5}, "ops": [["multiply", -2.0]]},
]

PROGRAM_YAML = """
- when: {sigma_min: 1.0, sigma_max: 9.0}
  ops:
    - [multiply, 1.5]
    - [ffilter, {filter: lowpass, threshold: 0.2, scale: 0.5, strength: 1.0}]
    - [enhance, {mode: blur, scale: 0.6}]
- ops: [abs, [roll, {dim: 2, amount: -1}]]
"""


@pytest.mark.parametrize("program,reference", [(PROGRAM, False), (PROGRAM, True),
                                               (PROGRAM[0], False), ([], False)])
def test_bleh_ops_noise(program, reference):
    ref = (np.random.default_rng(4).standard_normal((2, 4, 12, 10)).astype(np.float32)
           if reference else None)
    (jn,), (tn,) = stubs("ops")
    sig = [(14.6, 9.0), (9.0, 5.0), (5.0, 1.0), (1.0, 0.4), (0.4, 0.0)]
    run_both(JO.BlehOpsNoise(noise=jn, rules=program, reference=ref),
             TO.BlehOpsNoise(noise=tn, rules=program, reference=ref), (2, 4, 12, 10), n=5,
             sigmas=sig)


def test_bleh_ops_yaml_program():
    pytest.importorskip("yaml")
    (jn,), (tn,) = stubs("ops")
    rules = TO.OpsRuleGroup.build(PROGRAM_YAML)
    assert len(rules.rules) == 2 and rules.rules[0].sigma_min == 1.0
    run_both(JO.BlehOpsNoise(noise=jn, rules=PROGRAM_YAML),
             TO.BlehOpsNoise(noise=tn, rules=PROGRAM_YAML), (1, 4, 12, 10), n=3,
             sigmas=[(14.6, 9.0), (9.0, 5.0), (5.0, 1.0)])


def test_ops_rules_match_on_float32_sigmas():
    rule = TO.OpsRule.build({"when": {"sigma_min": 0.1, "sigma_max": 0.3}, "ops": ["neg"]})
    assert rule.matches({"sigma": 0.1}) and rule.matches({"sigma": np.float32(0.3)})
    assert not rule.matches({"sigma": 0.31}) and rule.matches({})
    assert rule.matches({"sigma": [0.05, 0.2]}) and not rule.matches({"sigma": 0.0999999})
    t = torch.ones(2)
    assert torch.equal(rule.apply({"h": t, "sigma": 0.2})["h"], -t)
    assert rule.apply({"h": t, "sigma": 0.5})["h"] is t
    with pytest.raises(ValueError, match="Unknown op"):
        TO.OpsRule.build({"ops": ["nope"]})
    assert set(TO.OPS_TABLE) == set(JO.OPS_TABLE)


def test_bleh_ops_refuses_an_empty_chain():
    from sonar_tpu_torch.noise import NoiseChain

    with pytest.raises(ValueError, match="at least one"):
        TO.BlehOpsNoise(noise=NoiseChain([]), rules=[])


# ---------------------------------------------------------------------------
# the helpers the algebra stands on: utils.misc, normalize_to_scale_adv,
# prepare_ref_latent(strict_reference_compat=), NoiseCtx.ref_like (1e-6)
# ---------------------------------------------------------------------------

HELPER_REL = 1e-6


def test_misc_helpers():
    import jax.numpy as jnp

    import sonar_tpu.utils.misc as JM
    import sonar_tpu_torch.utils.misc as TM

    x = exemplar((2, 3, 9, 11)) * 3
    close_rel(TM.trunc_decimals(torch.from_numpy(x), 2), JM.trunc_decimals(jnp.asarray(x), 2),
              HELPER_REL)
    for s, size, off in [(slice(2, 5), 9, 3), (slice(2, 5), 9, -4), (slice(None, 4), 9, 7),
                         (slice(1, None), 9, -1), (slice(0, 3), 9, 0)]:
        assert TM.adjust_slice(s, size, off) == JM.adjust_slice(s, size, off)
    for mode in ["center", "top_left", "top_center", "top_right", "center_left",
                 "center_right", "bottom_left", "bottom_center", "bottom_right"]:
        for ow, oh in [(0, 0), (2, -1), (-9, 9)]:
            got = TM.crop_samples(torch.from_numpy(x), 6, 5, mode=mode, offset_width=ow,
                                  offset_height=oh)
            want = JM.crop_samples(jnp.asarray(x), 6, 5, mode=mode, offset_width=ow,
                                   offset_height=oh)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for bad in ["middle", "top_middle", "top_left_x"]:
        with pytest.raises(ValueError):
            TM.crop_samples(torch.from_numpy(x), 6, 5, mode=bad)
    with pytest.raises(ValueError, match="smaller"):
        TM.crop_samples(torch.from_numpy(x), 12, 5)
    for kw in [{}, {"percentage": 0.3, "detail_level": 4.0}, {"restore_scale": False}]:
        close_rel(TM.pattern_break(torch.from_numpy(x), **kw),
                  JM.pattern_break(jnp.asarray(x), **kw), HELPER_REL)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    got = TM.pattern_break(bf)
    assert got.dtype == torch.bfloat16
    want = JM.pattern_break(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))
    close_rel(got.float(), np.asarray(want.astype(jnp.float32)), 2.0**-7)


@pytest.mark.parametrize("dim,prob,no_identity", [(-1, 1.0, False), (1, 0.5, False),
                                                  (2, 1.0, True), (0, 0.7, True)])
def test_elementwise_shuffle_by_dim(dim, prob, no_identity, choices):
    import jax
    import jax.numpy as jnp

    import sonar_tpu.utils.misc as JM
    import sonar_tpu_torch.utils.misc as TM

    x = exemplar((2, 3, 4, 5))
    want = JM.elementwise_shuffle_by_dim(jnp.asarray(x), jax.random.key(0), dim=dim, prob=prob,
                                         no_identity=no_identity)
    got = TM.elementwise_shuffle_by_dim(torch.from_numpy(x), 3, dim=dim, prob=prob,
                                        no_identity=no_identity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert choices.pos["jax"] == choices.pos["torch"]
    # each line along dim keeps its values
    np.testing.assert_array_equal(np.sort(got.numpy(), axis=dim), np.sort(x, axis=dim))
    if no_identity and prob == 1.0:
        assert not (got.numpy() == x).any()


@pytest.mark.parametrize("kw", [
    dict(min_pos=0.0, max_pos=1.0, min_neg=-1.0, max_neg=0.0),
    dict(min_pos=-1.0, max_pos=2.0, min_neg=-3.0, max_neg=0.5),
    dict(min_pos=0.2, max_pos=0.8, min_neg=-0.8, max_neg=-0.2),
    dict(min_pos=1.0, max_pos=0.0, min_neg=0.5, max_neg=1.0),
])
def test_normalize_to_scale_adv(kw):
    import jax.numpy as jnp

    from sonar_tpu.core.normalize import normalize_to_scale_adv as jadv
    from sonar_tpu_torch.core.normalize import normalize_to_scale_adv as tadv

    x = exemplar((2, 4, 6, 6)) * 2.5
    x[0, 0, 0, :3] = 0.0
    close_rel(tadv(torch.from_numpy(x), **kw), jadv(jnp.asarray(x), **kw), HELPER_REL)


@pytest.mark.parametrize("strict", [False, True])
def test_prepare_ref_latent_strict(strict):
    import jax.numpy as jnp

    from sonar_tpu.samplers.guidance import prepare_ref_latent as jprep
    from sonar_tpu_torch.samplers.guidance import prepare_ref_latent as tprep

    x = exemplar((1, 4, 8, 8))
    x[0, 1] = 0.25  # a constant channel: zero std
    got = tprep(torch.from_numpy(x), strict_reference_compat=strict).numpy()
    want = np.asarray(jprep(jnp.asarray(x), strict_reference_compat=strict))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() == strict
    close_rel(np.nan_to_num(got), np.nan_to_num(want), HELPER_REL)


@pytest.mark.parametrize("ref_shape,shape", [((1, 4, 8, 8), (1, 4, 8, 8)),
                                             ((1, 4, 5, 7), (1, 4, 8, 8)),
                                             ((1, 4, 9, 12), (1, 4, 6, 6)),
                                             ((1, 3, 8, 8), (1, 4, 8, 8)),
                                             ((4, 8, 8), (1, 4, 8, 8))])
def test_ref_like(ref_shape, shape):
    import jax.numpy as jnp

    from sonar_tpu.noise.base import NoiseCtx as JCtx
    from sonar_tpu_torch.noise.base import NoiseCtx as TCtx

    ref = exemplar(ref_shape)
    want = JCtx(shape=shape, ref=jnp.asarray(ref)).ref_like()
    got = TCtx(shape=shape, device="cpu", ref=torch.from_numpy(ref)).ref_like()
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == torch.float32
        close_rel(got, want, HELPER_REL)
    assert TCtx(shape=shape, device="cpu").ref_like() is None
    bf = TCtx(shape=shape, device="cpu", dtype=torch.bfloat16, ref=ref).ref_like()
    assert bf is None or bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# config 5's Voronoi z-walk cell and tree C, whole, against JAX
# ---------------------------------------------------------------------------


def _zwalk(M, V):
    """tools/bench_configs.py:143-157, for either package."""
    inner = V.VoronoiGenerator(n_points=(32,), z_increment=0.35, z_range=10.0,
                               result_mode=("f1",))
    return M.PerDimNoise(noise=M.CustomNoiseParametersNoise(noise=inner, frames_to_channels=True,
                                                            normalize=False),
                         dim=2, chunk_size=1, normalize=False)


def test_voronoi_zwalk_cell(monkeypatch):
    import jax.numpy as jnp

    import sonar_tpu.noise.voronoi as JV
    import sonar_tpu_torch.noise.voronoi as TV

    rng, draws, pos = np.random.default_rng(0), [], {"jax": 0, "torch": 0}

    def points(side, gen, ctx):
        i = pos[side]
        pos[side] += 1
        while len(draws) <= i:
            draws.append(tuple(rng.random((ctx.batch, ctx.channels, gen._npoints(g), 3),
                                          dtype=np.float32)
                               for g in range(gen._octave_groups())))
        return draws[i]

    monkeypatch.setattr(JV.VoronoiGenerator, "_draw_feature_points",
                        lambda self, ctx, st, key, s, sn: (
                            tuple(jnp.asarray(f) for f in points("jax", self, ctx)), st))
    monkeypatch.setattr(TV.VoronoiGenerator, "_draw_feature_points",
                        lambda self, ctx, st, seed, s, sn: (
                            tuple(torch.from_numpy(f.copy()) for f in points("torch", self, ctx)),
                            st))
    shape = (1, 4, 4, 32, 32)
    outs, jst, tst = run_both(_zwalk(JC, JV), _zwalk(TC, TV), shape, n=3,
                              sigmas=[(1.0, 0.9)] * 3)
    assert pos["jax"] == pos["torch"] == 1 + 3 * 4  # init, then one a frame
    z = tst["node"]["noise"]["noise"]["z"]
    assert abs(float(z) - 3 * 4 * 0.35) < 1e-5
    close_rel(z, np.asarray(jst["node"]["noise"]["noise"]["z"]))
    # frames differ (z moved between them)
    assert not torch.equal(outs[0][:, :, 0], outs[0][:, :, 1])


def _tree_c(M, G, L, guide):
    from sonar_tpu.noise import presets as JP
    from sonar_tpu_torch.noise import presets as TP

    P = JP if M is JC else TP
    g = P.get_noise_item
    leaves = {"gauss_r": g("gaussian"), "pyr": g("pyramid"), "gauss_l": g("gaussian"),
              "perlin": g("perlin"), "gauss_2": g("gaussian")}
    for tag, leaf in leaves.items():
        leaf._tag = tag
    op = L.SonarLatentOperationQuantileFilter(quantile=0.9, strategy="tanh", start_sigma=5.0)
    return M.BlendedNoise(
        custom_noise_mask=leaves["perlin"],
        custom_noise_1=M.GuidedNoise(
            ref_latent=guide, method="euler",
            noise=M.RandomNoise(mix_count=2, noise=[
                M.ResizedNoise(custom_noise=leaves["gauss_r"], width=256, height=256),
                M.PerDimNoise(noise=leaves["pyr"], dim=1),
                M.LatentOperationFilteredNoise(noise=leaves["gauss_l"], operations=[op])])),
        custom_noise_2=leaves["gauss_2"])


def test_tree_c_noise_sequence(monkeypatch, choices):
    """Tree C of chip_smoke.py [25] over a 6-step schedule: the leaves draw
    shared numpy normals keyed by (leaf, sigma, call), so JAX's RandomNoise,
    which computes the unpicked children too, hands the picked ones the
    port's draws."""
    import jax.numpy as jnp

    import sonar_tpu.cfg.latent_ops as JL
    import sonar_tpu.noise.generators as JG
    import sonar_tpu_torch.cfg.latent_ops as TL
    import sonar_tpu_torch.noise.generators as TG

    table, calls = {}, {"jax": {}, "torch": {}}

    def normals(side, tag, sigma, shape):
        k = (tag, round(float(sigma), 6))
        i = calls[side][k] = calls[side].get(k, -1) + 1
        key = k + (i, tuple(shape))
        if key not in table:
            seed = [zlib.crc32(tag.encode()), int(float(sigma) * 1e6), i, *shape]
            table[key] = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        return table[key]

    for cls in ("GaussianGenerator", "PerlinOldGenerator", "PyramidGenerator"):
        monkeypatch.setattr(getattr(JG, cls), "generate", lambda self, ctx, st, key, s, sn: (
            jnp.asarray(normals("jax", self._tag, s, ctx.shape)), st))
        monkeypatch.setattr(getattr(TG, cls), "generate", lambda self, ctx, st, seed, s, sn: (
            torch.from_numpy(normals("torch", self._tag, s, ctx.shape).copy()), st))
    guide = exemplar((1, 4, 32, 32), seed=11)
    sig = np.array([14.6, 6.2, 2.5, 0.9, 0.3, 0.03, 0.0], np.float32)
    pairs = [(float(a), float(b)) for a, b in zip(sig[:-1], sig[1:])]
    shape = (1, 4, 16, 16)
    outs, _, _ = run_both(_tree_c(JC, JG, JL, guide), _tree_c(TC, TG, TL, guide), shape,
                          n=6, sigmas=pairs, ref=exemplar(shape, seed=2))
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_new_modules_import_nothing_of_jax():
    import pathlib
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import sonar_tpu_torch.noise.combinators, sonar_tpu_torch.noise.blendfilter\n"
        "import sonar_tpu_torch.noise.ops_engine, sonar_tpu_torch.noise.wavelet\n"
        "import sonar_tpu_torch.noise, sonar_tpu_torch.utils.misc\n"
        "from sonar_tpu_torch.noise import get_noise_item\n"
        "get_noise_item('wavelet')\n"
        "bad = [m for m in ('jax', 'jaxlib', 'sonar_tpu', 'yaml', 'scipy', 'triton')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
