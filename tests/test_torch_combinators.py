"""The port's noise combinator algebra against the JAX package's, on the CPU.

Each combinator runs over stub children that hand out rows of one numpy
table on both sides (row ``i`` of a table per stub tag and shape, ``i`` a
counter in the stub's state), so the combinators are compared on equal
inputs. A stub may add half of the exemplar latent it is handed
(``ctx.ref_like()``), which holds how each combinator conforms the exemplar
for its children. The combinators' own random choices come from one numpy
table too: the JAX package's ``jax.random`` inside ``combinators`` and
``utils.misc`` is replaced by a stand-in that reads it in call order, and
the port's choice functions (``repeat_choices``, ``random_choices``) and
its Philox uniforms (``hwrng.philox_rand``, ShuffledNoise's) read the same
table in the same order. Both sides must ask for the same draws in the same
order.

Tolerance: 1e-5 relative to max(1, |JAX|) for each draw (reductions in
another order), 1e-4 where an FFT is on the path (ModulatedNoise's frequency
and spectral modes). Each run also holds every stub's draw count (a child
that did not run keeps its state).
"""

import numpy as np
import pytest
import torch

import sonar_tpu.noise.combinators as JC
import sonar_tpu_torch.noise.combinators as TC
from _combinator_stubs import (REL, REL_FFT, SIGMAS, JStub, TStub, choices, close_rel,
                               exemplar, run_both, stub_counts, stubs)
from sonar_tpu_torch.noise.base import make_noise_sampler

__all__ = ["choices"]  # the fixture, imported for pytest


SHAPE = (2, 4, 8, 8)


# ---------------------------------------------------------------------------
# CompositeNoise, GuidedNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_hw,norm", [((8, 8), None), ((5, 3), None), ((16, 16), False)])
def test_composite(mask_hw, norm):
    mask = np.random.default_rng(2).random((1,) + mask_hw).astype(np.float32)
    (jd, js), (td, ts) = stubs("dst", "src")
    kw = dict(mask=mask, normalize_dst=norm, normalize_result=norm)
    run_both(JC.CompositeNoise(dst_noise=jd, src_noise=js, **kw),
             TC.CompositeNoise(dst_noise=td, src_noise=ts, **kw), SHAPE)


@pytest.mark.parametrize("method", ["linear", "euler"])
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("with_noise", [True, False])
def test_guided(method, with_ref, with_noise):
    guide = exemplar((1, 4, 5, 6), seed=3)
    (jn,), (tn,) = stubs("g")
    kw = dict(ref_latent=guide, method=method, guidance_factor=0.4)
    run_both(JC.GuidedNoise(noise=jn if with_noise else None, **kw),
             TC.GuidedNoise(noise=tn if with_noise else None, **kw), SHAPE,
             ref=exemplar(SHAPE) if with_ref else None, n=4)


def test_guided_zero_sigma():
    (jn,), (tn,) = stubs("g")
    kw = dict(ref_latent=exemplar((1, 4, 8, 8), seed=3), method="euler")
    run_both(JC.GuidedNoise(noise=jn, **kw), TC.GuidedNoise(noise=tn, **kw), SHAPE,
             sigmas=[(0.0, 0.5), (1.0, 0.0)], n=2)


# ---------------------------------------------------------------------------
# RepeatedNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("permute", ["enabled", "disabled", "always"])
def test_repeated(permute, choices):
    (jn,), (tn,) = stubs("rep")
    kw = dict(repeat_length=3, max_recycle=2, permute=permute)
    sig = SIGMAS + SIGMAS[:4]
    outs, jst, tst = run_both(JC.RepeatedNoise(noise=jn, **kw), TC.RepeatedNoise(noise=tn, **kw),
                              (1, 3, 6, 8), n=len(sig), sigmas=sig)
    node_j, node_t = jst["node"], tst["node"]
    assert list(np.asarray(node_j["counts"])) == list(node_t["counts"])
    assert int(node_j["filled"]) == node_t["filled"] == 3
    assert int(node_j["last_idx"]) == node_t["last_idx"]
    # reuse and refresh both happened: fewer child draws than samples, and
    # more than the cache's length
    assert 3 < node_t["noise"]["i"] < len(sig)
    for a, b in zip(np.asarray(node_j["cache"]), node_t["cache"]):
        close_rel(b, a)


def test_repeated_permutations_cover_every_branch(monkeypatch):
    noise = torch.arange(24.0).reshape(1, 2, 3, 4)
    P = TC.RepeatedNoise._permuted
    assert torch.equal(P(noise, 0, 2, 0), noise)
    assert torch.equal(P(noise, 0, 3, 0), -noise)
    big = TC.INT32_MAX // 5 + 1
    d1 = big % 4
    assert torch.equal(P(noise, 0, big, big), torch.flip(noise, dims=(d1,)))
    assert torch.equal(P(noise, 0, big, big + 1), torch.flip(noise, dims=(d1, (big + 1) % 4)))
    assert torch.equal(P(noise, 1, 6, 7), torch.roll(noise, 7 % 3, dims=2))
    seen = {TC.repeat_choices(s, 5, True)[0] for s in range(200)}
    assert seen == set(range(5))
    assert TC.repeat_choices(3, 5, False)[1:] == (None, None, None)


# ---------------------------------------------------------------------------
# ModulatedNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mtype", ["intensity", "frequency", "spectral_signum"])
@pytest.mark.parametrize("mdims", [1, 2, 3])
def test_modulated(mtype, mdims):
    (jn,), (tn,) = stubs("mod")
    kw = dict(modulation_type=mtype, modulation_dims=mdims, modulation_strength=1.5)
    rel = REL if mtype == "intensity" else REL_FFT
    run_both(JC.ModulatedNoise(noise=jn, **kw), TC.ModulatedNoise(noise=tn, **kw), SHAPE,
             ref=exemplar(SHAPE), rel=rel, n=3,
             sigmas=[s for s in SIGMAS if s[0] != s[1]])


@pytest.mark.parametrize("how", ["none", "opt", "resized_exemplar", "no_ref"])
def test_modulated_references(how):
    (jn,), (tn,) = stubs("mod")
    kw = dict(modulation_type="none" if how == "none" else "intensity",
              ref_latent_opt=exemplar(SHAPE, 4) if how == "opt" else None)
    ref = {"resized_exemplar": exemplar((2, 4, 5, 7)), "no_ref": None}.get(how, exemplar(SHAPE))
    run_both(JC.ModulatedNoise(noise=jn, **kw), TC.ModulatedNoise(noise=tn, **kw), SHAPE,
             ref=ref, n=3, sigmas=[s for s in SIGMAS if s[0] != s[1]])


# ---------------------------------------------------------------------------
# RandomNoise, ChannelNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix", [0, 1, 2])
def test_random(mix, choices):
    js, ts = stubs("r0", "r1", "r2", "r3")
    outs, jst, tst = run_both(JC.RandomNoise(noise=js, mix_count=mix),
                              TC.RandomNoise(noise=ts, mix_count=mix), SHAPE, n=10)
    counts = stub_counts(tst["node"])
    assert sum(counts) == 10 * mix and min(counts) < 10  # unchosen children kept their state
    if mix == 0:
        assert not any(bool(o.any()) for o in outs)


def test_random_choices_are_distinct_and_host_ints():
    for s in range(50):
        c = TC.random_choices(s, 5, 3)
        assert len(set(c)) == 3 and all(isinstance(v, int) and 0 <= v < 5 for v in c)
    assert {TC.random_choices(s, 4, 1)[0] for s in range(100)} == {0, 1, 2, 3}


@pytest.mark.parametrize("mode", ["wrap", "repeat", "zero"])
def test_channel(mode):
    js, ts = stubs("c0", "c1", reads_ref=True)
    kw = dict(insufficient_channels_mode=mode)
    run_both(JC.ChannelNoise(noise=js, **kw), TC.ChannelNoise(noise=ts, **kw), SHAPE,
             ref=exemplar(SHAPE), n=3)


# ---------------------------------------------------------------------------
# RippleFilteredNoise, NormalizeToScaleNoise, BlendedNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"mode": "cos", "dim": 2, "period": 3.0, "roll": 1.5, "amplitude_low": 0.5},
    {"mode": "sin_copysign", "flatten": True, "dim": 1, "roll": 2.0},
    {"mode": "cos_copysign", "offset": 0.7, "normalize_noise": True},
])
def test_ripple(kw):
    (jn,), (tn,) = stubs("rip")
    run_both(JC.RippleFilteredNoise(noise=jn, **kw), TC.RippleFilteredNoise(noise=tn, **kw),
             SHAPE, n=4)


@pytest.mark.parametrize("kw", [
    {},
    {"dims": (1, 2, 3)},
    {"dims": (-1,), "min_negative_value": -2.0, "max_positive_value": 0.5},
    {"mode": "advanced", "min_negative_value": -1.0, "max_negative_value": -0.25,
     "min_positive_value": 0.25, "max_positive_value": 2.0},
    {"mode": "advanced", "max_negative_value": 0.0, "min_positive_value": -1.0, "dims": (1,)},
    {"mode": "advanced", "min_negative_value": 0.5, "max_negative_value": 1.0,
     "min_positive_value": 0.0, "max_positive_value": 1.0},
    {"mean_multiplier": 0.5, "mean_dims": (-2, -1), "std_multiplier": 0.7, "std_dims": (1,)},
    {"mean_multiplier": 1.0, "std_multiplier": 1.0},
])
def test_normalize_to_scale(kw):
    (jn,), (tn,) = stubs("nts")
    run_both(JC.NormalizeToScaleNoise(noise=jn, **kw), TC.NormalizeToScaleNoise(noise=tn, **kw),
             SHAPE, n=3)


@pytest.mark.parametrize("kw,children", [
    ({}, ("b1", "b2", None)),
    ({"blend_function": "slerp", "noise_2_percent": 0.3}, ("b1", "b2", None)),
    ({"noise_2_percent": 0.2}, ("b1", "b2", "bm")),
    ({"noise_2_percent": 1.0}, (None, "b2", None)),
    ({"noise_2_percent": 0.0}, ("b1", None, None)),
])
def test_blended(kw, children):
    names = ("custom_noise_1", "custom_noise_2", "custom_noise_mask")
    jkw = {n: JStub(tag=t) for n, t in zip(names, children) if t}
    tkw = {n: TStub(tag=t) for n, t in zip(names, children) if t}
    run_both(JC.BlendedNoise(**jkw, **kw), TC.BlendedNoise(**tkw, **kw), SHAPE, n=3)


# ---------------------------------------------------------------------------
# ResizedNoise
# ---------------------------------------------------------------------------

ANCHORS = ["center", "top_left", "top_center", "top_right", "center_left", "center_right",
           "bottom_left", "bottom_center", "bottom_right"]


@pytest.mark.parametrize("spatial_mode,w,h", [("absolute", 40, 48), ("absolute", 96, 112),
                                              ("relative", 16, -24), ("percentage", 0.5, 1.5)])
@pytest.mark.parametrize("initial_reference", ["prefer_crop", "prefer_scale"])
def test_resized_modes(spatial_mode, w, h, initial_reference):
    (jn,), (tn,) = stubs("rs", reads_ref=True)
    kw = dict(width=w, height=h, spatial_mode=spatial_mode, initial_reference=initial_reference,
              upscale_mode="bicubic", downscale_mode="area")
    run_both(JC.ResizedNoise(custom_noise=jn, **kw), TC.ResizedNoise(custom_noise=tn, **kw),
             SHAPE, ref=exemplar(SHAPE), n=2)


@pytest.mark.parametrize("anchor", ANCHORS)
@pytest.mark.parametrize("initial_reference", ["prefer_crop", "prefer_scale"])
def test_resized_crop_anchors(anchor, initial_reference):
    (jn,), (tn,) = stubs("rs", reads_ref=True)
    # larger in both: the draw is cropped; the exemplar is upscaled
    kw = dict(width=112, height=96, crop_mode=anchor, crop_offset_horizontal=16,
              crop_offset_vertical=-8, downscale_strategy="crop",
              initial_reference=initial_reference)
    run_both(JC.ResizedNoise(custom_noise=jn, **kw), TC.ResizedNoise(custom_noise=tn, **kw),
             SHAPE, ref=exemplar(SHAPE), n=2)
    # smaller in both: the exemplar is cropped (prefer_crop) or scaled down
    kw = dict(width=40, height=32, crop_mode=anchor, crop_offset_horizontal=-8,
              crop_offset_vertical=8, initial_reference=initial_reference)
    run_both(JC.ResizedNoise(custom_noise=jn, **kw), TC.ResizedNoise(custom_noise=tn, **kw),
             SHAPE, ref=exemplar(SHAPE), n=2)


def test_resized_same_size_passes_through():
    (jn,), (tn,) = stubs("rs")
    kw = dict(width=64, height=64, normalize=False)
    run_both(JC.ResizedNoise(2.0, custom_noise=jn, **kw),
             TC.ResizedNoise(2.0, custom_noise=tn, **kw), SHAPE, n=2)


# ---------------------------------------------------------------------------
# LatentOperationFilteredNoise, QuantileFilteredNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [{}, {"start_sigma": 4.0, "end_sigma": 1.0}])
def test_latent_operation_filtered(window):
    from sonar_tpu.cfg.latent_ops import SonarLatentOperationQuantileFilter as JQ
    from sonar_tpu_torch.cfg.latent_ops import SonarLatentOperationQuantileFilter as TQ

    (jn,), (tn,) = stubs("lo")
    kw = dict(quantile=0.8, strategy="tanh", **window)
    run_both(JC.LatentOperationFilteredNoise(noise=jn, operations=[JQ(**kw)]),
             TC.LatentOperationFilteredNoise(noise=tn, operations=[TQ(**kw)]), SHAPE, n=6)


@pytest.mark.parametrize("kw", [{}, {"quantile": 0.7, "strategy": "tanh", "norm_pow": 1.0},
                                {"quantile": -0.6, "norm_dim": None, "strategy": "scale_down"},
                                {"quantile": [0.9, 0.75], "norm_flatten": False,
                                 "normalize_noise": True}])
def test_quantile_filtered(kw):
    (jn,), (tn,) = stubs("qf")
    run_both(JC.QuantileFilteredNoise(noise=jn, **kw), TC.QuantileFilteredNoise(noise=tn, **kw),
             SHAPE, n=3)


# ---------------------------------------------------------------------------
# PerDimNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("dim,chunk", [(2, 1), (2, 2), (-1, 3), (1, 1)])
def test_per_dim_5d(shrink, dim, chunk):
    (jn,), (tn,) = stubs("pd", reads_ref=True)
    kw = dict(dim=dim, chunk_size=chunk, shrink_dim=shrink, normalize_noise=True)
    shape = (1, 2, 5, 6, 7)
    run_both(JC.PerDimNoise(noise=jn, **kw), TC.PerDimNoise(noise=tn, **kw), shape,
             ref=exemplar(shape), n=3)


def test_per_dim_rejects_bad_dims():
    (tn,) = stubs("pd")[1]
    with pytest.raises(ValueError, match="out of range"):
        make_noise_sampler(TC.PerDimNoise(noise=tn, dim=5), SHAPE, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        make_noise_sampler(TC.PerDimNoise(noise=tn, dim=1, offset=3, chunk_size=2), SHAPE,
                           device="cpu")


# ---------------------------------------------------------------------------
# ShuffledNoise, PatternBreakNoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"dims": (1, -1), "percentages": (0.5,)},
                                {"dims": (2, 3), "percentages": (1.0, 0.3), "no_identity": True},
                                {"dims": (0,), "no_identity": True},
                                {"percentages": (0.0,)}])
def test_shuffled(kw, choices):
    (jn,), (tn,) = stubs("sh")
    run_both(JC.ShuffledNoise(noise=jn, **kw), TC.ShuffledNoise(noise=tn, **kw), SHAPE, n=3)
    assert choices.pos["jax"] == choices.pos["torch"]


@pytest.mark.parametrize("kw", [{}, {"percentage": 0.4, "detail_level": 2.0},
                                {"restore_scale": False, "blend_mode": "inject"},
                                {"percentage": 0.0}])
def test_pattern_break(kw):
    (jn,), (tn,) = stubs("pb")
    run_both(JC.PatternBreakNoise(noise=jn, **kw), TC.PatternBreakNoise(noise=tn, **kw), SHAPE,
             n=3)


# ---------------------------------------------------------------------------
# nesting, clone, unchanged ScheduledNoise under the new classes
# ---------------------------------------------------------------------------


def test_nested_tree(choices):
    def tree(M, S):
        return M.BlendedNoise(
            custom_noise_1=M.RepeatedNoise(noise=M.ChannelNoise(
                noise=[S(tag="n0"), M.ScheduledNoise(noise=S(tag="n1"), start_sigma=5.0,
                                                     fallback_noise=S(tag="n2"))]),
                repeat_length=2, max_recycle=1),
            custom_noise_2=M.RandomNoise(noise=[S(tag="n3"), S(tag="n4")]),
            noise_2_percent=0.3)

    run_both(tree(JC, JStub), tree(TC, TStub), SHAPE, n=8)


def test_clone_keeps_parameters():
    (tn,) = stubs("c")[1]
    for item in (TC.PatternBreakNoise(noise=tn, percentage=0.3),
                 TC.GuidedNoise(ref_latent=exemplar((1, 4, 4, 4)), noise=tn),
                 TC.RandomNoise(noise=[tn, TStub(tag="d")], mix_count=2),
                 TC.ChannelNoise(noise=[tn], insufficient_channels_mode="zero")):
        c = item.clone()
        assert type(c) is type(item) and c.params().keys() == item.params().keys()
        assert c is not item
