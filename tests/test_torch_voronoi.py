"""Voronoi noise in the port against the JAX package: kernel B6 (on the CPU,
its plain version), the kernel plan, the generator's modes, the octave
modes, the z walk, the custom-noise chain and the sonar sampler.

Tolerances:
- B6's plain version against the JAX Pallas kernel in interpret mode (and
  against the JAX composition on a ragged shape the TPU kernel cannot
  tile): bit for bit for quadratic and chebyshev; within 2 float32 ulps
  for euclidean and minkowski (XLA's CPU pow rounds differently from
  torch's by an ulp, and by one more on hosts whose vector units XLA's code
  takes another path on; the k-th smallest toroidal distance reaches 0.87
  at k = 3, where an ulp is 5.96e-8, so no absolute margin below 1.2e-7
  holds). Against the Pallas kernel each side is also held to the float32
  arithmetic itself, computed with numpy (three rounded squares, a rounded
  sum, a correctly rounded root): the port's plain version bit for bit for
  euclidean, quadratic and chebyshev, so a failure says which side moved;
- generator draws on shared numpy feature points (and shared gaussian
  draws where a gaussian is mixed in): 2e-5 relative to max(1, |JAX|),
  since the draws pass through scale_noise, whose mean and std are summed
  in another order, and through arccos/tanh/sin, whose ulps differ;
- the sampler fed each package's Voronoi draws: 1e-4 relative to the
  trajectory's largest magnitude (as tests/test_torch_sampler.py);
- random parts (the fuzz modes, Philox feature points): statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import sonar_tpu.kernels.voronoi as JKV
import sonar_tpu.models.unet as ju
import sonar_tpu.noise.generators as JG
import sonar_tpu.noise.voronoi as JV
import sonar_tpu.samplers.sonar as js
from sonar_tpu.core.normalize import normalize_to_scale as j_normalize_to_scale
from sonar_tpu.core.normalize import tmedian as j_tmedian
from sonar_tpu.noise import make_noise_sampler as j_make_noise_sampler
from sonar_tpu.noise.chain import NoiseChain as JChain
from sonar_tpu.noise.items import TypedNoiseItem as JTyped
import sonar_tpu_torch.kernels.voronoi as TKV
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.noise.generators as TG
import sonar_tpu_torch.noise.voronoi as TV
import sonar_tpu_torch.samplers.sonar as ts
from sonar_tpu_torch.core.normalize import normalize_to_scale, tmedian
from sonar_tpu_torch.noise import (NoiseChain, NoiseCtx, TypedNoiseItem, get_noise_item,
                                   make_noise_sampler)
from sonar_tpu_torch.samplers.momentum import SonarConfig
from sonar_tpu_torch.utils import fallback, maybe_apply

GEN_REL = 2e-5
EXACT = ("quadratic", "chebyshev")


def _close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= rel * scale, (err, rel * scale)


# ---------------------------------------------------------------------------
# B6: the k smallest toroidal distances
# ---------------------------------------------------------------------------

B6_CASES = [  # test_voronoi_kernel.py:49-57, then k in {1, 2, 4, 8}
    ("euclidean", 3.0, None, 1.0, 3),
    ("euclidean", 3.0, None, 2.0, 1),
    ("quadratic", 3.0, None, 1.0, 4),
    ("chebyshev", 3.0, None, 4.0, 2),
    ("minkowski", 2.5, None, 1.0, 3),
    ("euclidean", 3.0, (2.0, 1.0, 0.25), 2.0, 3),
    ("euclidean", 3.0, None, 8.0, 8),
    ("euclidean", 3.0, None, 1.0, 2),
    ("quadratic", 3.0, (1.0, 2.0, 0.5), 2.0, 8),
    ("chebyshev", 3.0, None, 1.0, 1),
    ("minkowski", 3.0, None, 2.0, 4),
]


def _grid(h, w):
    return np.asarray(jnp.linspace(0, h - 1, h) / h), np.asarray(jnp.linspace(0, w - 1, w) / w)


def _b6_inputs(b, c, n, h, w, seed=0):
    fp = np.random.default_rng(seed).random((b, c, n, 3), dtype=np.float32)
    ys, xs = _grid(h, w)
    return fp, ys, xs


def _assert_b6(got, want, dist):
    if dist in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=2)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _numpy_b6(fp, ys, xs, z, *, scale, k, dist, p, weights):
    """The float32 arithmetic of B6 in numpy (its sqrt is correctly rounded):
    ``(k smallest, the squared sums)`` of the euclidean and quadratic cases'
    distances, ``(k smallest, None)`` otherwise."""
    f = np.float32
    b, c, n, _ = fp.shape
    wy, wx, wz = (f(v) for v in weights)
    fm = (fp * f(scale)) % f(1.0)
    gy, gx = (ys.astype(f) * f(scale)) % f(1.0), (xs.astype(f) * f(scale)) % f(1.0)
    dzw = (((f(z) * f(scale)) % f(1.0) - fm[..., 2] + f(0.5)) % f(1.0) - f(0.5)) * wz
    fy, fx = fm[..., 0].reshape(b * c, 1, 1, n), fm[..., 1].reshape(b * c, 1, 1, n)
    dy = ((gy.reshape(1, -1, 1, 1) - fy + f(0.5)) % f(1.0) - f(0.5)) * wy
    dx = ((gx.reshape(1, 1, -1, 1) - fx + f(0.5)) % f(1.0) - f(0.5)) * wx
    sq = None
    if dist in ("euclidean", "quadratic"):
        sq = dy * dy + dx * dx + (dzw * dzw).reshape(b * c, 1, 1, n)
        d = np.sqrt(sq) if dist == "euclidean" else sq
    elif dist == "chebyshev":
        d = np.maximum(np.maximum(np.abs(dy), np.abs(dx)), np.abs(dzw).reshape(b * c, 1, 1, n))
    else:
        d = (np.abs(dy) ** f(p) + np.abs(dx) ** f(p)
             + (np.abs(dzw) ** f(p)).reshape(b * c, 1, 1, n)) ** f(1.0 / p)
    out = np.sort(d, axis=-1)[..., :k].reshape(b, c, len(ys), len(xs), k)
    return out, sq


def _assert_b6_sides(got, want, dist, fp, ys, xs, z, kw):
    """``_assert_b6``, with each side first held to the numpy arithmetic: a
    failure names the side that left it, its worst element, the ulps and the
    squared sums there."""
    arith, sq = _numpy_b6(fp, ys, xs, z, **kw)
    for side, val in (("the port's plain version", got), ("JAX's interpret kernel", want)):
        u = _ulps(val, arith)
        if dist == "minkowski" or not u.any():
            continue
        i = np.unravel_index(int(u.argmax()), u.shape)
        sums = None if sq is None else np.sort(sq.reshape(*val.shape[:-1], -1), axis=-1)[i[:-1]]
        assert side == "JAX's interpret kernel" and u.max() <= 2, (
            f"{side} left the float32 arithmetic: {int(u.max())} ulps at {i}, "
            f"{val[i]!r} against {arith[i]!r}; the pixel's smallest squared sums {sums}")
    _assert_b6(got, want, dist)


def _port_b6(fp, ys, xs, z, **kw):
    return TKV.voronoi_ksmallest(torch.from_numpy(fp), torch.from_numpy(ys.copy()),
                                 torch.from_numpy(xs.copy()), torch.tensor(z), **kw).numpy()


@pytest.mark.parametrize("dist,p,weights,scale,k", B6_CASES)
def test_ksmallest_plain_matches_pallas_interpret(dist, p, weights, scale, k):
    fp, ys, xs = _b6_inputs(1, 2, 37, 16, 24)
    kw = dict(scale=scale, k=k, dist=dist, p=p, weights=weights or (1.0, 1.0, 1.0))
    want = np.asarray(JKV.voronoi_ksmallest(jnp.asarray(fp), jnp.asarray(ys), jnp.asarray(xs),
                                            jnp.float32(0.37), interpret=True, **kw))
    got = _port_b6(fp, ys, xs, 0.37, **kw)
    assert got.shape == (1, 2, 16, 24, k) and got.dtype == np.float32
    _assert_b6_sides(got, want, dist, fp, ys, xs, 0.37, kw)
    # the grid vectors are arange(L) / L in the port, bit for bit
    np.testing.assert_array_equal(ys, (torch.arange(16) / 16).numpy())


def _jax_axis_ksmallest(fp, ys, xs, z, scale, dist, p, weights, k):
    """The JAX package's per-axis path (VoronoiGenerator._axis_distance) and
    a sort: the reference where the Pallas kernel cannot tile."""
    h, w = len(ys), len(xs)
    grid = jnp.stack(jnp.meshgrid(jnp.asarray(ys), jnp.asarray(xs), indexing="ij"), axis=-1)
    grid3d = jnp.concatenate([grid, jnp.full((h, w, 1), jnp.float32(z))], axis=-1)
    d = JV.VoronoiGenerator()._axis_distance((dist, p, weights, 1.0), grid3d,
                                             jnp.asarray(fp), scale)
    return np.asarray(jnp.sort(d, axis=-1)[..., :k])


@pytest.mark.parametrize("dist,p", [("euclidean", 3.0), ("quadratic", 3.0),
                                    ("chebyshev", 3.0), ("minkowski", 2.5)])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_ksmallest_plain_ragged_matches_jax_composition(dist, p, k):
    fp, ys, xs = _b6_inputs(1, 3, 29, 67, 61, seed=1)
    weights = (1.5, 1.0, 0.5)
    want = _jax_axis_ksmallest(fp, ys, xs, 0.61, 2.0, dist, p, weights, k)
    got = _port_b6(fp, ys, xs, 0.61, scale=2.0, k=k, dist=dist, p=p, weights=weights)
    _assert_b6(got, want, dist)


def _insert(mins, d):
    """Kernel B6's sorted insertion on float32: mins stays ascending."""
    for j in range(len(mins)):
        lo, hi = min(mins[j], d), max(mins[j], d)
        mins[j], d = lo, hi


_F32 = st.floats(min_value=0.0, max_value=4.0, width=32, allow_nan=False)
_SQUARES = st.lists(st.one_of(_F32, st.sampled_from([0.0, 0.25, 1.0, 2.0**-149, 2.0**-126])),
                    min_size=1, max_size=40)


@settings(max_examples=200, deadline=None)
@given(squares=_SQUARES, k=st.integers(1, 8))
def test_roots_of_the_k_smallest_squares_are_the_k_smallest_roots(squares, k):
    """B6 selects on the squared euclidean distance and takes k roots at the
    end: sqrt is correctly rounded, hence monotone, so the result equals
    selecting on the roots bit for bit, ties and zeros included."""
    sq = torch.tensor(squares, dtype=torch.float32)
    k = min(k, len(squares))
    deferred = torch.sqrt(torch.topk(sq, k, largest=False, sorted=True).values)
    direct = torch.topk(torch.sqrt(sq), k, largest=False, sorted=True).values
    assert torch.equal(deferred, direct)


@settings(max_examples=200, deadline=None)
@given(values=_SQUARES, k=st.integers(1, 8), parts=st.sampled_from([1, 2, 4, 8]))
def test_merged_part_prefixes_are_the_k_smallest(values, k, parts):
    """B6 splits a tile's points over the warps of a block: each part keeps
    its own sorted k-prefix (+inf where it holds fewer than k points) and
    the prefixes are merged by the same insertion. The k smallest of the
    union of the parts' k smallest are the k smallest of the whole."""
    vals = np.asarray(values, np.float32)
    k = min(k, len(vals))
    prefixes = []
    for part in range(parts):  # the kernel's split: point i goes to part i % parts
        mins = [np.float32(np.inf)] * k
        for d in vals[part::parts]:
            _insert(mins, d)
        prefixes.append(mins)
    merged = list(prefixes[0])
    for other in prefixes[1:]:
        for d in other:
            _insert(merged, d)
    want = torch.topk(torch.from_numpy(vals), k, largest=False, sorted=True).values.numpy()
    np.testing.assert_array_equal(np.asarray(merged, np.float32), want)


def test_ksmallest_wrapper_routes_and_refuses():
    fp, ys, xs = _b6_inputs(1, 2, 5, 8, 8)
    n = TKV.voronoi_ksmallest.launches
    out = _port_b6(fp, ys, xs, 0.0, scale=1.0, k=2)
    assert TKV.voronoi_ksmallest.launches == n  # the CPU runs the plain version
    assert np.all(np.diff(out, axis=-1) >= 0)
    for bad in (dict(k=9), dict(k=6), dict(k=0), dict(k=2, dist="angle")):
        with pytest.raises(ValueError):
            _port_b6(fp, ys, xs, 0.0, scale=1.0, **bad)
    with pytest.raises(ValueError, match="device"):
        TKV.voronoi_ksmallest(torch.zeros((1, 1, 4, 3), device="meta"),
                              torch.zeros(4, device="meta"), torch.zeros(4, device="meta"),
                              0.0, scale=1.0, k=2)
    # the port's gate drops the TPU's tiling conditions, keeps k <= min(8, N)
    assert TKV.voronoi_kernel_supported(67, 61, 4, "euclidean", 3, 37)
    assert not JKV.voronoi_kernel_supported(67, 61, 4, "euclidean", 3, 37)
    assert not TKV.voronoi_kernel_supported(64, 64, 4, "euclidean", 4, 2)
    assert not TKV.voronoi_kernel_supported(64, 64, 2, "euclidean", 70000, 16)


# ---------------------------------------------------------------------------
# the plan and the sorted prefix
# ---------------------------------------------------------------------------

PLAN_SPECS = [
    dict(result_mode=("f2",)),
    dict(result_mode=("f2",), distance_mode=("manhatten",)),
    dict(result_mode=("diff2",)),
    dict(result_mode=("f1+f:idx=3",)),
    dict(result_mode=("ridge:name=diff:idx2=2",)),
    dict(result_mode=("f2",), distance_mode=("weight:name=chebyshev:h=2",)),
    dict(result_mode=("f2",), distance_mode=("minkowski:p=2.5",)),
    dict(result_mode=("fuzz:name=f3",)),
    dict(result_mode=("gradient_magnitude:name1=f2:name2=diff",)),
    dict(result_mode=("f:idx=7",)),
    dict(result_mode=("f:idx=8",)),
    dict(),
    dict(result_mode=("softmin",)),
    dict(result_mode=("median_distance",)),
    dict(result_mode=("cellid",)),
    dict(result_mode=("f:idx=-1",)),
    dict(result_mode=("f2",), distance_mode=("angle",)),
    dict(result_mode=("f2",), distance_mode=("euclidean+chebyshev",)),
    dict(result_mode=("f2",), distance_mode=("euclidean:dscale=-1",)),
    dict(result_mode=("f2",), distance_mode=("euclidean:dscale=0.5",)),
    dict(result_mode=("fractal_norm",)),
    dict(n_points=(3,), result_mode=("f4",)),
]


class _JCtx:
    dtype = jnp.float32
    batch = 1
    channels = 4


@pytest.mark.parametrize("spec", range(len(PLAN_SPECS)))
def test_kernel_plan_matches_jax(monkeypatch, spec):
    monkeypatch.setattr(JKV, "use_voronoi_kernel", lambda: True)
    kw = {"n_points": (16,), **PLAN_SPECS[spec]}
    want = JV.VoronoiGenerator(**kw)._kernel_plan(_JCtx(), 0, 64, 64)
    if PLAN_SPECS[spec] == {}:
        # f1, the default: the JAX package keeps a prefix of one off its TPU
        # kernel; the port's kernel takes it, as a prefix like any other
        assert want is None
        want = ("euclidean", 3.0, None, 1.0, 1)
    ctx = NoiseCtx(shape=(1, 4, 64, 64), device="cpu")
    gen = TV.VoronoiGenerator(**kw)
    assert gen._kernel_plan(ctx, 0, 64, 64) == want
    # the TPU's tiling conditions are gone: a ragged height plans the same
    assert gen._kernel_plan(ctx, 0, 67, 61) == want
    # a non-float32 context takes the plain path, as in JAX (voronoi.py:489)
    assert gen._kernel_plan(NoiseCtx(shape=(1, 4, 64, 64), dtype=torch.bfloat16, device="cpu"),
                            0, 64, 64) is None


RESULT_SPECS = ["f1", "f2", "f3+f4", "f:idx=5", "f:idx=-2", "inv_f2", "inv_f:idx=2",
                "diff", "diff2:idx1=1:idx2=3", "cellid", "ridge", "ridge:name=f3",
                "median_distance", "softmin", "softmin:use_sorted=1",
                "gradient_magnitude", "gradient_magnitude:name1=f1:name2=inv_f2",
                "fractal_norm", "fuzz", "fuzz:name=diff2", "f2+median_distance"]


@pytest.mark.parametrize("spec", RESULT_SPECS)
def test_sorted_prefix_matches_jax(spec):
    want = JV._sorted_prefix(JV._parse_modes(spec, "rscale"))
    assert TV._sorted_prefix(TV._parse_modes(spec, "rscale")) == want
    assert TV._parse_modes(spec, "rscale") == JV._parse_modes(spec, "rscale")
    d = np.random.default_rng(4).random((2, 3, 5, 6, 12), dtype=np.float32)
    if want is not None and want > 0:
        np.testing.assert_array_equal(TV._sorted_small(torch.from_numpy(d), want).numpy(),
                                      np.asarray(JV._sorted_small(jnp.asarray(d), want)))
    np.testing.assert_array_equal(TV._sorted_small(torch.from_numpy(d), None).numpy(),
                                  np.sort(d, axis=-1))


def test_parse_and_simple_distance_match_jax():
    for spec in ["euclidean", "weight:name=chebyshev:h=2:_z=0.5", "minkowski:p=2.5:dscale=3",
                 "fuzz:name=angle_tanh:fuzz=0.1", "euclidean+chebyshev:dscale=2",
                 "manhatten", "fractal_norm:name=quadratic"]:
        parsed = TV._parse_modes(spec, "dscale")
        assert parsed == JV._parse_modes(spec, "dscale")
        assert TV._simple_distance(parsed) == JV._simple_distance(parsed)


# ---------------------------------------------------------------------------
# the generator on shared feature points
# ---------------------------------------------------------------------------


def _inject_points(monkeypatch, seed=0):
    """Patch both packages' _draw_feature_points to hand out the same numpy
    points, call by call (init first, then one call per reset-mode draw)."""
    rng = np.random.default_rng(seed)
    draws, calls = [], {"jax": 0, "torch": 0}

    def points(side, gen, ctx):
        i = calls[side]
        calls[side] += 1
        while len(draws) <= i:
            draws.append(tuple(
                rng.random((ctx.batch, ctx.channels, gen._npoints(g), 3), dtype=np.float32)
                for g in range(gen._octave_groups())))
        return draws[i]

    def jdraw(self, ctx, state, key, sigma, sigma_next):
        return tuple(jnp.asarray(f) for f in points("jax", self, ctx)), state

    def tdraw(self, ctx, state, seed, sigma, sigma_next):
        return tuple(torch.from_numpy(f.copy()) for f in points("torch", self, ctx)), state

    monkeypatch.setattr(JV.VoronoiGenerator, "_draw_feature_points", jdraw)
    monkeypatch.setattr(TV.VoronoiGenerator, "_draw_feature_points", tdraw)
    return calls


def _inject_gaussian(monkeypatch, seed=1):
    """Both packages' GaussianGenerator draw the same numpy normals."""
    rng = np.random.default_rng(seed)
    draws, calls = [], {"jax": 0, "torch": 0}

    def normals(side, shape):
        i = calls[side]
        calls[side] += 1
        while len(draws) <= i:
            draws.append(rng.standard_normal(shape).astype(np.float32))
        assert draws[i].shape == tuple(shape)
        return draws[i]

    monkeypatch.setattr(JG.GaussianGenerator, "generate", lambda self, ctx, st, key, s, sn: (
        jnp.asarray(normals("jax", ctx.shape)), st))
    monkeypatch.setattr(TG.GaussianGenerator, "generate", lambda self, ctx, st, seed, s, sn: (
        torch.from_numpy(normals("torch", ctx.shape).copy()), st))


def _draws_both(jitem, titem, shape, n=3, sigmas=(1.0, 0.9)):
    jfn, jst = j_make_noise_sampler(jitem, shape, seed=5)
    tfn, tst = make_noise_sampler(titem, shape, seed=5, device="cpu")
    out = []
    for _ in range(n):
        a, jst = jfn(jst, *sigmas)
        b, tst = tfn(tst, *sigmas)
        out.append((np.asarray(a), b.numpy()))
    return out, jst, tst


def _check_generator(monkeypatch, shape=(1, 2, 16, 16), n=3, **kw):
    _inject_points(monkeypatch)
    kw = {"n_points": (16,), "z_max": 0.0, **kw}
    draws, jst, tst = _draws_both(JV.VoronoiGenerator(**kw), TV.VoronoiGenerator(**kw),
                                  shape, n)
    for a, b in draws:
        assert np.isfinite(b).all()
        _close_rel(b, a, GEN_REL)
    return jst, tst


DISTANCE_MODES = ["euclidean", "manhatten", "chebyshev", "minkowski:p=2.5", "quadratic",
                  "angle", "angle_tanh:idx=1", "angle_sigmoid",
                  "weight:name=euclidean:h=2:z=0.5", "weight:name=minkowski:w=0.5",
                  "fractal_norm:name=quadratic:mode=cos", "euclidean+chebyshev:dscale=2",
                  "euclidean:dscale=0.5"]


@pytest.mark.parametrize("distance", DISTANCE_MODES)
def test_generator_distance_modes_match_jax(monkeypatch, distance):
    _check_generator(monkeypatch, distance_mode=(distance,), result_mode=("f2",))


NONRANDOM_RESULTS = ["f", "f:idx=2", "f1", "f2", "f3", "f4", "inv_f", "inv_f1", "inv_f2",
                     "inv_f3", "inv_f4", "diff", "diff2", "ridge", "median_distance",
                     "softmin", "softmin:use_sorted=1:temperature=20",
                     "gradient_magnitude", "gradient_magnitude:pad_mode=reflect",
                     "gradient_magnitude:pad_mode=circular:name1=f1:name2=f2",
                     "gradient_magnitude:pad_mode=constant", "fractal_norm",
                     "fractal_norm:name=f2:mode=cos", "f1:rscale=2+diff2", "f:idx=-1"]


@pytest.mark.parametrize("result", NONRANDOM_RESULTS)
def test_generator_result_modes_match_jax(monkeypatch, result):
    _check_generator(monkeypatch, result_mode=(result,))


def test_generator_cellid_matches_jax(monkeypatch):
    # argmin of the distances: quadratic, bit-equal in both packages, so no
    # near-tie can pick another cell
    _check_generator(monkeypatch, distance_mode=("quadratic",), result_mode=("cellid",))


F1_DISTANCES = ["euclidean", "quadratic", "chebyshev", "minkowski:p=2.5",
                "weight:name=euclidean:h=2:z=0.5", "euclidean:dscale=0.5"]


@pytest.mark.parametrize("distance", F1_DISTANCES)
def test_f1_takes_the_kernel_route(monkeypatch, distance):
    """f1 (a prefix of one) goes through voronoi_ksmallest, once per octave;
    its values are the per-axis path's bit for bit (gate closed: the
    distance tensor and a min; minkowski within 1e-6), and the JAX
    generator's at 2e-5."""
    calls = []
    real = TV.voronoi_ksmallest
    monkeypatch.setattr(TV, "voronoi_ksmallest",
                        lambda *a, **kw: calls.append(kw["k"]) or real(*a, **kw))
    kw = dict(n_points=(16, 9), octaves=2, octave_mode="new_features",
              distance_mode=(distance,), result_mode=("f1",), z_max=0.0)
    _check_generator(monkeypatch, shape=(1, 3, 12, 20), n=2, **kw)
    assert calls == [1, 1, 1, 1]  # two draws, two octaves, k = 1

    def draw():
        _inject_points(monkeypatch)  # the same points for both routes
        fn, st = make_noise_sampler(TV.VoronoiGenerator(**kw), (1, 3, 12, 20), seed=5,
                                    normalized=False, device="cpu")
        return fn(st, 1.0, 0.9)[0]

    routed = draw()
    assert len(calls) == 6
    monkeypatch.setattr(TV, "voronoi_kernel_supported", lambda *a: False)
    per_axis = draw()
    assert len(calls) == 6  # the gate is closed: no further call
    if distance.startswith("minkowski"):
        # the host's pow takes its vector or its scalar loop by the operands'
        # layout and the two differ by an ulp: the kernel's own limit, 1e-6
        _close_rel(routed.numpy(), per_axis.numpy(), 1e-6)
    else:
        assert torch.equal(routed, per_axis)


OCTAVE_MODES = ["same_features", "new_features", "same_invert_odd", "same_invert_even",
                "same_roll_chan_up", "same_roll_chan_down", "same_roll_dir_up",
                "same_roll_dir_down"]


@pytest.mark.parametrize("octave_mode", OCTAVE_MODES)
def test_generator_octave_modes_match_jax(monkeypatch, octave_mode):
    _check_generator(monkeypatch, shape=(1, 3, 12, 20), octaves=3, octave_mode=octave_mode,
                     n_points=(16, 9), result_mode=("diff2", "f1"),
                     distance_mode=("euclidean", "chebyshev"), gain=0.75,
                     initial_amplitude=2.0, initial_scale=1.5)


@pytest.mark.parametrize("z_max_mode", ["reset", "bounce", "wrap"])
def test_generator_z_walk_matches_jax(monkeypatch, z_max_mode):
    jst, tst = _check_generator(monkeypatch, n=3, z_max=1.0, z_increment=0.75, z_initial=0.25,
                                z_max_mode=z_max_mode, result_mode=("f2",), z_range=3)
    for k in ("z", "zinc"):
        np.testing.assert_allclose(float(tst["node"][k]), float(jst["node"][k]), rtol=1e-6)
        assert tst["node"][k].dtype == torch.float32


def test_generator_factory_points_match_jax(monkeypatch):
    """noise_sampler_factory: the points come from a nested generator,
    normalized to [0, 1] (py/noise_generation.py:1367-1404)."""
    _inject_gaussian(monkeypatch)
    kw = dict(n_points=(12,), octaves=2, octave_mode="new_features", result_mode=("diff2",),
              z_max=0.0)
    draws, _, tst = _draws_both(
        JV.VoronoiGenerator(noise_sampler_factory=JG.GaussianGenerator(), **kw),
        TV.VoronoiGenerator(noise_sampler_factory=TG.GaussianGenerator(), **kw),
        (1, 2, 16, 16))
    for a, b in draws:
        _close_rel(b, a, GEN_REL)
    for fp in tst["node"]["fp"]:
        assert float(fp.min()) >= 0.0 and float(fp.max()) <= 1.0


def test_voronoi_mix_matches_jax_on_shared_draws(monkeypatch):
    _inject_points(monkeypatch)
    _inject_gaussian(monkeypatch)
    import sonar_tpu.noise.presets as jp

    draws, _, _ = _draws_both(jp.get_noise_item("voronoi_mix"), get_noise_item("voronoi_mix"),
                              (1, 4, 16, 16))
    for a, b in draws:
        _close_rel(b, a, GEN_REL)


def test_voronoi_presets_have_the_jax_parameters():
    import sonar_tpu.noise.presets as jp

    for name in ("voronoi_fuzz", "voronoi_mix"):
        want, got = jp.get_noise_item(name), get_noise_item(name)
        members = [(want, got)] if name == "voronoi_fuzz" else [
            (wm[0], gm[0]) for wm, gm in zip(want.noise_mix, got.noise_mix)]
        for w, g in members:
            assert type(g).__name__ == type(w).__name__
            assert g.params().keys() == w.params().keys()
            for k, v in w.params().items():
                assert g.params()[k] == v, (name, k)
        if name == "voronoi_mix":
            assert [t for _, t in got.noise_mix] == [t for _, t in want.noise_mix]


# ---------------------------------------------------------------------------
# random parts, by statistics
# ---------------------------------------------------------------------------


def test_philox_feature_points_are_uniform_and_seeded():
    gen = TV.VoronoiGenerator(n_points=(4096,), octaves=2, octave_mode="new_features")
    ctx = NoiseCtx(shape=(1, 4, 8, 8), device="cpu")
    a, b = gen.init_state(ctx, 3), gen.init_state(ctx, 3)
    assert all(torch.equal(x, y) for x, y in zip(a["fp"], b["fp"]))
    assert not torch.equal(a["fp"][0], a["fp"][1])  # the two groups draw apart
    assert not torch.equal(a["fp"][0], gen.init_state(ctx, 4)["fp"][0])
    fp = torch.cat([f.reshape(-1) for f in a["fp"]]).double()
    assert fp.numel() == 2 * 4 * 4096 * 3 and float(fp.min()) >= 0 and float(fp.max()) < 1
    assert abs(float(fp.mean()) - 0.5) < 0.005
    assert abs(float(fp.var()) - 1 / 12) < 0.002
    # Kolmogorov-Smirnov distance to U[0, 1): well inside the 1 % critical
    # value 1.63 / sqrt(n)
    s = torch.sort(fp).values
    ks = float(torch.max(torch.abs(s - torch.arange(len(s), dtype=torch.float64) / len(s))))
    assert ks < 1.63 / len(s) ** 0.5


@pytest.mark.parametrize("spec", [
    dict(distance_mode=("fuzz:name=angle_tanh:fuzz=0.1",), result_mode=("diff2",)),
    dict(result_mode=("fuzz:name=f2:fuzz=0.3",)),
])
def test_fuzz_modes_by_statistics(spec):
    """Fuzz adds U(-1, 1)·max(|min|, |max|)·fuzz and remaps into the
    unfuzzed range: each draw stays in range, is seeded, and the two
    packages' raw fields agree in their moments."""
    kw = {"n_points": (32,), "z_max": 0.0, **spec}
    shape = (1, 4, 32, 32)
    tfn, tst = make_noise_sampler(TV.VoronoiGenerator(**kw), shape, seed=2, normalized=False,
                                  device="cpu")
    jfn, jst = j_make_noise_sampler(JV.VoronoiGenerator(**kw), shape, seed=2,
                                    normalized=False)
    t_draws, j_draws = [], []
    for _ in range(4):
        b, tst = tfn(tst, 1.0, 0.9)
        a, jst = jfn(jst, 1.0, 0.9)
        t_draws.append(b.double())
        j_draws.append(torch.from_numpy(np.asarray(a, np.float64)))
    fn2, st2 = make_noise_sampler(TV.VoronoiGenerator(**kw), shape, seed=2, normalized=False,
                                  device="cpu")
    first, _ = fn2(st2, 1.0, 0.9)
    assert torch.equal(first.double(), t_draws[0])
    assert not torch.equal(t_draws[0], t_draws[1])
    t, j = torch.stack(t_draws), torch.stack(j_draws)
    assert torch.isfinite(t).all()
    assert abs(float(t.mean()) - float(j.mean())) < 0.1 * max(float(j.std()), 1e-3) + 0.02
    assert abs(float(t.std()) / float(j.std()) - 1) < 0.2


def test_voronoi_fuzz_preset_draws():
    fn, st = make_noise_sampler(get_noise_item("voronoi_fuzz"), (1, 4, 16, 16), seed=9,
                                device="cpu")
    a, st = fn(st, 1.0, 0.9)
    b, _ = fn(st, 1.0, 0.9)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    # scale_noise divides by the std; the raw field's mean (~0.02) lies
    # inside the 2.5/sqrt(N) dead-band, so it is not subtracted
    assert abs(float(a.double().std()) - 1) < 1e-3 and float(a.min()) >= 0


# ---------------------------------------------------------------------------
# the custom-noise chain
# ---------------------------------------------------------------------------


def _chains(jax_side: bool):
    V, Chain, Typed = ((JV.VoronoiGenerator, JChain, JTyped) if jax_side
                       else (TV.VoronoiGenerator, NoiseChain, TypedNoiseItem))
    chain = Chain([Typed(0.5, noise_type="gaussian"),
                   V(1.5, n_points=(16,), result_mode=("f2",), z_max=0.0)])
    chain.add(Typed(-0.25, noise_type="voronoi_mix", override_sigma=2.0))
    return chain


def test_chain_and_typed_items_match_jax(monkeypatch):
    _inject_points(monkeypatch)
    _inject_gaussian(monkeypatch)
    jchain, tchain = _chains(True), _chains(False)
    assert tchain.chain_factor == jchain.chain_factor == 2.25
    jr, tr = jchain.rescaled(1.5), tchain.rescaled(1.5)
    assert [i.factor for i in tr.items] == [i.factor for i in jr.items]
    assert [i.factor for i in tchain.items] == [0.5, 1.5, -0.25]  # rescaled cloned
    tc = tchain.clone()
    assert tc is not tchain and all(a is not b for a, b in zip(tc.items, tchain.items))
    assert repr(tc) == repr(tchain)
    assert tr.items[2].get_normalize("override_sigma") == 2.0
    assert tr.items[2].get_normalize("override_sigma_min", 0.1) == 0.1
    for j, t in ((jchain, tchain), (jr, tr)):
        draws, _, _ = _draws_both(j, t, (1, 4, 16, 16))
        for a, b in draws:
            _close_rel(b, a, GEN_REL)
    with pytest.raises(ValueError, match="nil"):
        tchain.add(None)
    with pytest.raises(ValueError, match="Empty"):
        NoiseChain().check_dims(NoiseCtx(shape=(1, 4, 8, 8)))


def test_generator_clone_and_helpers():
    g = TV.VoronoiGenerator(2.0, n_points=(8,), noise_sampler_factory=TG.GaussianGenerator(),
                            extra_option=3)
    c = g.clone()
    assert c is not g and c.params() | {"noise_sampler_factory": None} == \
        g.params() | {"noise_sampler_factory": None}
    assert c.noise_sampler_factory is not g.noise_sampler_factory
    assert c.options == {"extra_option": 3}
    assert g.set_factor(0.5) is g and g.factor == 0.5 and c.factor == 2.0
    mix = get_noise_item("voronoi_mix").clone()
    assert mix.noise_mix[0][0].n_points == (256,) and mix.noise_mix[1][1] == 0.4
    assert fallback(None, 3) == 3 and fallback(0, 3) == 0
    assert maybe_apply(2, True, lambda v: v * 5) == 10 and maybe_apply(2, False, None) == 2


@pytest.mark.parametrize("dim", [None, (), (-1, -2), (-3, -2, -1)])
def test_normalize_to_scale_and_tmedian_match_jax(dim):
    x = np.random.default_rng(6).standard_normal((2, 3, 5, 7)).astype(np.float32)
    kw = {} if dim == (-3, -2, -1) else {"dim": dim}
    np.testing.assert_allclose(normalize_to_scale(torch.from_numpy(x), -0.5, 2.0, **kw).numpy(),
                               np.asarray(j_normalize_to_scale(jnp.asarray(x), -0.5, 2.0, **kw)),
                               rtol=0, atol=1e-6)
    for axis in (-1, 1):
        for keep in (False, True):
            np.testing.assert_array_equal(
                tmedian(torch.from_numpy(x), axis=axis, keepdims=keep).numpy(),
                np.asarray(j_tmedian(jnp.asarray(x), axis=axis, keepdims=keep)))


# ---------------------------------------------------------------------------
# the slice: the sonar sampler with Voronoi noise
# ---------------------------------------------------------------------------


def _bench_sigmas(steps):
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return np.concatenate([s, [0.0]]).astype(np.float32)


def test_sampler_on_voronoi_draws_matches_jax(monkeypatch):
    """A narrow UNet through the sonar sampler, 6 steps, each package fed its
    own voronoi_mix draws made from the same feature points and normals."""
    _inject_points(monkeypatch)
    _inject_gaussian(monkeypatch)
    import sonar_tpu.noise.presets as jp

    kw = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,), num_heads=2,
              norm_groups=4)
    jcfg = ju.UNetConfig(**kw)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**kw))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    shape, sig = (1, 4, 16, 16), _bench_sigmas(6)
    draws, _, _ = _draws_both(jp.get_noise_item("voronoi_mix"), get_noise_item("voronoi_mix"),
                              shape, n=6)
    for a, b in draws:
        _close_rel(b, a, GEN_REL)
    jstack = jnp.asarray(np.stack([a for a, _ in draws]))
    x0 = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * sig[0]
    ref = js.sample_sonar_euler_ancestral(ju.make_denoiser(params, jcfg), jnp.asarray(x0),
                                          jnp.asarray(sig),
                                          noise_sampler=lambda i, s, sn: jstack[i])
    out = ts.sample_sonar_euler_ancestral(tu.make_denoiser(model.eval()),
                                          torch.from_numpy(x0), torch.from_numpy(sig),
                                          noise_sampler=lambda i, s, sn: torch.from_numpy(
                                              draws[i][1]))
    _close_rel(out.numpy(), np.asarray(ref), 1e-4)


def _stub(shape):
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape) / 1e3
    return lambda x, s, **_: ((x * 0.9 + t.to(x.dtype)) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)
                              ).to(x.dtype)


@pytest.mark.parametrize("entry", ["voronoi_mix", "voronoi_fuzz", "custom"])
def test_sampler_entry_points_on_cpu(entry):
    """The three entry points of the slice run through the sampler on the
    CPU (B6's plain version), reproducibly, and differ from gaussian."""
    shape, sig = (1, 4, 16, 16), torch.from_numpy(_bench_sigmas(4))
    if entry == "custom":
        cfg = SonarConfig(custom_noise=NoiseChain([TV.VoronoiGenerator(
            n_points=(32,), octaves=2, result_mode=("f3",), distance_mode=("quadratic",))]))
    else:
        cfg = SonarConfig(noise_type=entry)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    n = TKV.voronoi_ksmallest.launches
    run = lambda c: ts.sample_sonar_euler_ancestral(_stub(shape), x0 * 14.6, sig, seed=7,  # noqa: E731
                                                   sonar_config=c)
    out = run(cfg)
    assert TKV.voronoi_ksmallest.launches == n
    assert out.shape == shape and torch.isfinite(out).all()
    assert torch.equal(out, run(cfg))
    assert not torch.equal(out, run(SonarConfig()))
