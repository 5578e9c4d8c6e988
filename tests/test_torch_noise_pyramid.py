"""The pyramid noise family against the JAX package: kernels B4 and B5 (on
the CPU, their plain versions), the ladders and gates, the generators'
composed paths, the 13 registry names and the sonar sampler with
``noise_type="pyramid"``.

Tolerances:
- B4 and B5 plain versions against the JAX Pallas kernels in interpret mode
  (and against the JAX composition on ragged shapes the TPU kernels cannot
  tile): 2e-5 (B4: float32 products summed in another order) and 3e-5 (B5),
  absolute, as tests/test_fused_pyramid.py holds the JAX kernels;
- composed generator paths on shared numpy draws: 1e-5 absolute;
- statistics of independent streams (Philox here, threefry there): the
  margins of tests/test_reference_noise_stats_oracle.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.kernels.fused_pyramid as JFP
import sonar_tpu.noise.generators as JG
from sonar_tpu.noise import get_noise_item as j_get_noise_item
from sonar_tpu.noise import make_noise_sampler as j_make_noise_sampler
from sonar_tpu.ops.resample import scale_samples as j_scale_samples
import sonar_tpu_torch.kernels.fused_pyramid as TFP
import sonar_tpu_torch.noise.generators as TG
import sonar_tpu_torch.samplers.sonar as ts
from sonar_tpu_torch.core.rng import derive_seed
from sonar_tpu_torch.kernels import hwrng
from sonar_tpu_torch.noise import NoiseCtx, get_noise_item, make_noise_sampler
from sonar_tpu_torch.ops.resample import resize_taps
from sonar_tpu_torch.samplers.momentum import SonarConfig

PYRAMID_NAMES = [
    "pyramid", "highres_pyramid", "pyramid_old", "pyramid_bislerp",
    "highres_pyramid_bislerp", "pyramid_area", "highres_pyramid_area",
    "pyramid_old_bislerp", "pyramid_old_area", "pyramid_discount5", "pyramid_mix",
    "pyramid_mix_area", "pyramid_mix_bislerp",
]
UP_TOL, DOWN_TOL, COMPOSE_TOL = 2e-5, 3e-5, 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# B4: the upscale pyramid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", TFP.UP_MODES)
def test_pyramid_accumulate_matches_pallas_interpret(mode):
    rng = np.random.default_rng(0)
    bc, h, w = 3, 64, 128
    base = _randn(rng, bc, h, w)
    smalls = [_randn(rng, bc, sh, sw) for sh, sw in [(25, 50), (7, 11), (1, 1)]]
    discounts = [0.7, 0.49, 0.343]
    want = JFP.fused_pyramid_accumulate(jnp.asarray(base), [jnp.asarray(s) for s in smalls],
                                        discounts, mode=mode, interpret=True)
    got = TFP.fused_pyramid_accumulate(torch.from_numpy(base),
                                       [torch.from_numpy(s) for s in smalls], discounts, mode)
    _close(got, want, UP_TOL)


def test_pyramid_accumulate_tiled_rows_and_no_levels():
    rng = np.random.default_rng(3)
    base, small = _randn(rng, 2, 512, 128), _randn(rng, 2, 40, 40)
    want = JFP.fused_pyramid_accumulate(jnp.asarray(base), [jnp.asarray(small)], [0.7],
                                        interpret=True)
    got = TFP.fused_pyramid_accumulate(torch.from_numpy(base), [torch.from_numpy(small)],
                                       [0.7])
    _close(got, want, UP_TOL)
    base = torch.from_numpy(_randn(rng, 2, 16, 128))
    assert torch.equal(TFP.fused_pyramid_accumulate(base, [], []), base)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "area"])
def test_pyramid_accumulate_ragged_matches_jax_composition(mode):
    rng = np.random.default_rng(4)
    bc, h, w = 2, 67, 61  # no multiple of 8: the TPU kernel cannot tile it
    base = _randn(rng, bc, h, w)
    smalls = [_randn(rng, bc, sh, sw) for sh, sw in [(25, 20), (5, 3), (1, 1)]]
    want = jnp.asarray(base)
    for s, d in zip(smalls, [0.7, 0.49, 0.343]):
        want = want + j_scale_samples(jnp.asarray(s), w, h, mode=mode) * d
    got = TFP.fused_pyramid_accumulate(torch.from_numpy(base),
                                       [torch.from_numpy(s) for s in smalls],
                                       [0.7, 0.49, 0.343], mode)
    _close(got, want, UP_TOL)


def _tap_gather_accumulate(base, smalls, discounts, mode):
    """Kernel B4's arithmetic in plain torch: per level and output pixel the
    th x tw gathered taps of the level's tap tables, rows first, then
    columns, ascending; levels added in order."""
    bc, h, w = base.shape
    out = base
    for small, d in zip(smalls, discounts):
        sh, sw = small.shape[-2:]
        ridx, rval = resize_taps(sh, h, mode, device="cpu")
        cidx, cval = resize_taps(sw, w, mode, device="cpu")
        up = torch.zeros_like(base)
        for b in range(cidx.shape[1]):
            t = torch.zeros_like(base)
            for a in range(ridx.shape[1]):
                tapped = small[:, ridx[:, a].long()][:, :, cidx[:, b].long()]  # (bc, h, w)
                t = t + rval[:, a, None] * tapped
            up = up + t * cval[:, b]
        out = out + up * float(np.float32(d))
    return out


# (h, w), the levels below the base: the 64 and 512 ladders' shapes cut in
# width, the ragged one, clamped bicubic edges, a level as tall as the output
GATHER_CASES = [((64, 64), [(25, 25), (5, 5), (1, 1)]),
                ((512, 96), [(201, 38), (46, 9), (5, 1), (1, 1)]),
                ((67, 61), [(26, 23), (5, 5), (1, 1)]),
                ((9, 7), [(9, 3), (2, 3), (3, 2)])]


@pytest.mark.parametrize("mode", TFP.UP_MODES)
@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_tap_gather_matches_plain_version(mode, case):
    """Gathering over the tap tables skips the dense products' exact zeros
    and nothing else: 1e-6 relative to max(1, |plain|) (float32 sums in
    another order)."""
    (h, w), below = GATHER_CASES[case]
    rng = np.random.default_rng(case)
    base = torch.from_numpy(_randn(rng, 3, h, w))
    smalls = [torch.from_numpy(_randn(rng, 3, sh, sw)) for sh, sw in below]
    discounts = [0.7**i for i in range(1, len(below) + 1)]
    want = TFP.fused_pyramid_accumulate_reference(base, smalls, discounts, mode)
    got = _tap_gather_accumulate(base, smalls, discounts, mode)
    err = float((got.double() - want.double()).abs().max())
    assert err <= 1e-6 * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("mode", TFP.UP_MODES)
def test_tap_gather_matches_pallas_interpret(mode):
    rng = np.random.default_rng(0)
    bc, h, w = 3, 64, 128
    base = _randn(rng, bc, h, w)
    smalls = [_randn(rng, bc, sh, sw) for sh, sw in [(25, 50), (7, 11), (1, 1)]]
    discounts = [0.7, 0.49, 0.343]
    want = JFP.fused_pyramid_accumulate(jnp.asarray(base), [jnp.asarray(s) for s in smalls],
                                        discounts, mode=mode, interpret=True)
    got = _tap_gather_accumulate(torch.from_numpy(base),
                                 [torch.from_numpy(s) for s in smalls], discounts, mode)
    _close(got, want, UP_TOL)


def test_fused_pyramid_draw_is_its_stream_definition():
    shape, sizes = (1, 3, 64, 61), [(64, 61), (25, 24), (5, 4), (1, 1)]
    seed = derive_seed(5, "noise")
    got = TFP.fused_pyramid(seed, shape, sizes, 0.7, "bilinear", device="cpu")
    bseed = derive_seed(seed, "base")
    g1 = hwrng.philox_randn(bseed, (3, 64, 61), device="cpu", stream=0)
    g2 = hwrng.philox_randn(bseed, (3, 64, 61), device="cpu", stream=1)
    smalls = [hwrng.philox_randn(derive_seed(seed, "draw", i), (3, *s), device="cpu")
              for i, s in enumerate(sizes) if i]
    want = TFP.fused_pyramid_accumulate_reference(g1 + g2, smalls, [0.7, 0.49, 0.343])
    assert got.shape == shape and torch.equal(got, want.reshape(shape))
    fields = [g1, g2, *(s.reshape(-1)[:8] for s in smalls[:2])]
    flat = [f.reshape(-1)[:8] for f in fields]  # no two fields of one draw equal
    assert all(not torch.equal(a, b) for i, a in enumerate(flat) for b in flat[i + 1:])
    with pytest.raises(ValueError, match="not supported"):
        TFP.fused_pyramid(seed, shape, [(32, 32)], 0.7, device="cpu")


# ---------------------------------------------------------------------------
# B5: the downscale ladders
# ---------------------------------------------------------------------------


def _scatter_level(g, sh, sw, h, w, mode):
    """The (BC, 4, H, W) tap fields placed into a zero (BC, sh, sw) level at
    the positions _resize_matrix taps (tests/test_fused_pyramid.py)."""
    bc = g.shape[0]
    big = np.zeros((bc, sh, sw), np.float32)
    if sh == h and sw == w:
        return g[:, 0]
    if mode in ("nearest", "nearest-exact"):
        if mode == "nearest":
            r, c = (np.arange(h) * sh) // h, (np.arange(w) * sw) // w
        else:
            r = np.minimum(((np.arange(h) + 0.5) * sh / h).astype(np.int64), sh - 1)
            c = np.minimum(((np.arange(w) + 0.5) * sw / w).astype(np.int64), sw - 1)
        big[:, r[:, None], c[None, :]] = g[:, 0]
        return big
    r0 = np.floor((np.arange(h) + 0.5) * sh / h - 0.5).astype(np.int64)
    c0 = np.floor((np.arange(w) + 0.5) * sw / w - 0.5).astype(np.int64)
    for p, (a, b) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        big[:, (r0 + a)[:, None], (c0 + b)[None, :]] = g[:, p]
    return big


@pytest.mark.parametrize("mode", ["bilinear", "nearest-exact", "nearest"])
def test_downscale_accumulate_matches_pallas_interpret(mode):
    rng = np.random.default_rng(11)
    bc, h, w = 2, 16, 128
    sizes, coefs = [(16, 128), (33, 257), (64, 512)], [1.0, 0.7, 0.49]
    gs = [_randn(rng, bc, 4, h, w) for _ in sizes]
    base = _randn(rng, bc, h, w)
    want = JFP.fused_downscale_accumulate([jnp.asarray(g) for g in gs], (h, w), sizes,
                                          coefs, mode=mode, base=jnp.asarray(base),
                                          interpret=True)
    got = TFP.fused_downscale_accumulate([torch.from_numpy(g) for g in gs], (h, w), sizes,
                                         coefs, mode, base=torch.from_numpy(base))
    _close(got, want, DOWN_TOL)


def test_downscale_accumulate_no_base_and_area():
    rng = np.random.default_rng(4)
    g = _randn(rng, 1, 4, 8, 128)
    want = JFP.fused_downscale_accumulate([jnp.asarray(g)], (8, 128), [(32, 512)], [0.4],
                                          mode="nearest-exact", interpret=True)
    got = TFP.fused_downscale_accumulate([torch.from_numpy(g)], (8, 128), [(32, 512)],
                                         [0.4], "nearest-exact")
    _close(got, want, DOWN_TOL)
    g, base = _randn(rng, 1, 4, 16, 128), _randn(rng, 1, 16, 128)
    want = JFP.fused_downscale_accumulate([jnp.asarray(g)], (16, 128), [(64, 512)], [0.7],
                                          mode="area", base=jnp.asarray(base),
                                          interpret=True)
    got = TFP.fused_downscale_accumulate([torch.from_numpy(g)], (16, 128), [(64, 512)],
                                         [0.7], "area", base=torch.from_numpy(base))
    _close(got, want, DOWN_TOL)
    assert TFP._area_std(64, 512, 16, 128) == JFP._area_std(64, 512, 16, 128) == 0.25


@pytest.mark.parametrize("mode", ["bilinear", "nearest-exact", "nearest"])
def test_downscale_accumulate_ragged_matches_scattered_composition(mode):
    rng = np.random.default_rng(12)
    bc, h, w = 2, 67, 61
    # ratios exact in float32 (2, 4, 5), as in test_fused_pyramid.py: B5's
    # float32 tap coordinates then equal _resize_matrix's float64 ones
    sizes, coefs = [(67, 61), (134, 122), (268, 305)], [1.0, 0.7, 0.49]
    gs = [_randn(rng, bc, 4, h, w) for _ in sizes]
    base = _randn(rng, bc, h, w)
    want = base.astype(np.float64)
    for g, (sh, sw), cf in zip(gs, sizes, coefs):
        big = _scatter_level(g, sh, sw, h, w, mode)
        want = want + np.asarray(j_scale_samples(jnp.asarray(big), w, h, mode=mode)) * cf
    got = TFP.fused_downscale_accumulate([torch.from_numpy(g) for g in gs], (h, w), sizes,
                                         coefs, mode, base=torch.from_numpy(base))
    _close(got, want, DOWN_TOL)


def test_fused_downscale_draw_is_its_stream_definition():
    shape, sizes, coefs = (1, 2, 16, 13), [(16, 13), (40, 30), (64, 52)], [1.0, 0.7, 0.49]
    seed = derive_seed(9, "draw")
    base = torch.from_numpy(_randn(np.random.default_rng(1), *shape))
    got = TFP.fused_downscale_pyramid(seed, shape, sizes, coefs, "bilinear", base=base)
    fields = [torch.stack([hwrng.philox_randn(seed, (2, 16, 13), device="cpu",
                                              stream=4 * li + p) for p in range(4)], 1)
              for li in range(3)]
    want = TFP.fused_downscale_accumulate(fields, (16, 13), sizes, coefs, "bilinear",
                                          base=base.reshape(2, 16, 13))
    assert got.shape == shape and torch.equal(got, want.reshape(shape))
    flat = [f[:, p].reshape(-1)[:8] for f in fields for p in range(4)]
    assert all(not torch.equal(a, b) for i, a in enumerate(flat) for b in flat[i + 1:])
    with pytest.raises(ValueError, match="not supported"):
        TFP.fused_downscale_pyramid(seed, shape, [(20, 20)], [1.0], device="cpu")


# ---------------------------------------------------------------------------
# Ladders and gates
# ---------------------------------------------------------------------------


def test_size_ladders_equal_jax():
    for h, w in [(64, 64), (128, 96), (67, 61), (8, 8), (512, 512), (1, 3)]:
        for it in (1, 2, 4, 5, 10):
            for seed in (0, 1, 7, 123):
                assert (TG._size_ladder_highres(h, w, it, seed)
                        == JG._size_ladder_highres(h, w, it, seed))
                assert (TG._size_ladder_pyramid(h, w, it, seed)
                        == JG._size_ladder_pyramid(h, w, it, seed))
    # the launch counts chip_smoke.py asserts rest on these ladders
    assert TG._size_ladder_pyramid(64, 64, 10, 0) == [(64, 64), (25, 25), (5, 5), (1, 1)]
    assert TG._size_ladder_highres(64, 64, 4, 0) == [(64, 64), (162, 162), (702, 702),
                                                      (960, 960)]


def test_gates_equal_jax_on_tileable_shapes():
    lad = TG._size_ladder_pyramid(128, 128, 10, 0)
    up_cases = [(lad, 128, 128, "bilinear"), (lad, 128, 128, "bislerp"),
                ([(64, 64)], 128, 128, "bilinear"), (lad, 129, 128, "bilinear")]
    for h, w in [(64, 64), (128, 96), (16, 128)]:
        for mode in TFP.UP_MODES + ("bislerp", "adaptive_avg_pool2d"):
            up_cases.append((TG._size_ladder_pyramid(h, w, 10, 3), h, w, mode))
            up_cases.append(([(h, w), (h + 1, w)], h, w, mode))
    for case in up_cases:
        assert TFP.fused_pyramid_supported(*case) == JFP.fused_pyramid_supported(*case), case
    down_cases = [([(16, 128), (33, 257)], 16, 128, "bilinear"),
                  ([(24, 200)], 16, 128, "bilinear"), ([(32, 256)], 16, 128, "bicubic"),
                  ([(32, 256)], 16, 128, "area"), ([(33, 256)], 16, 128, "area")]
    for h, w in [(64, 64), (32, 48)]:
        for mode in TFP.DOWN_MODES + ("bicubic", "bislerp"):
            down_cases.append((TG._size_ladder_highres(h, w, 4, 0), h, w, mode))
            down_cases.append(([(h * 2 ** (i + 1), w * 2 ** (i + 1)) for i in range(5)],
                               h, w, mode))
    for case in down_cases:
        assert (TFP.fused_downscale_supported(*case)
                == JFP.fused_downscale_supported(*case)), case
    assert TFP.fused_pyramid_supported(lad, 128, 128, "bilinear")
    assert TFP.fused_downscale_supported([(16, 128), (33, 257)], 16, 128, "bilinear")


def test_gates_drop_the_tpu_tiling_conditions():
    # h % 8 != 0 and w < 8 are the TPU kernels' tiling limits, not the math's
    lad = TG._size_ladder_pyramid(67, 61, 10, 0)
    assert TFP.fused_pyramid_supported(lad, 67, 61, "bilinear")
    assert not JFP.fused_pyramid_supported(lad, 67, 61, "bilinear")
    assert TFP.fused_pyramid_supported([(16, 4), (5, 1)], 16, 4, "bicubic")
    assert not JFP.fused_pyramid_supported([(16, 4), (5, 1)], 16, 4, "bicubic")
    assert TFP.fused_downscale_supported([(67, 61), (134, 122)], 67, 61, "area")
    assert not JFP.fused_downscale_supported([(67, 61), (134, 122)], 67, 61, "area")
    # the kernels' parameter arrays bound the ladder
    long = [(64, 64)] * (TFP.MAX_LEVELS + 2)
    assert not TFP.fused_pyramid_supported(long, 64, 64, "bilinear")
    assert not TFP.fused_downscale_supported(long, 64, 64, "bilinear")


# ---------------------------------------------------------------------------
# Generators: structure of the composed paths on shared numpy draws
# ---------------------------------------------------------------------------


class _NumpyDraws:
    """Stands in for the port's Philox draws and records them in order."""

    def __init__(self):
        self.rng, self.log = np.random.default_rng(21), []

    def randn(self, ctx, seed, shape=None, dtype=None):
        return self._draw(self.rng.standard_normal(tuple(shape or ctx.adjusted_shape())))

    def rand(self, ctx, seed, shape=None, dtype=None):
        return self._draw(self.rng.random(tuple(shape or ctx.adjusted_shape())))

    def _draw(self, a):
        a = a.astype(np.float32)
        self.log.append(a)
        return torch.from_numpy(a)


@pytest.fixture()
def numpy_draws(monkeypatch):
    d = _NumpyDraws()
    monkeypatch.setattr(TG.Generator, "randn", d.randn)
    monkeypatch.setattr(TG.Generator, "rand", d.rand)
    return d


def _generate(name, shape, **kw):
    gen = get_noise_item(name, **kw)
    ctx = NoiseCtx(shape=shape, device="cpu")
    return gen, gen.generate(ctx, gen.init_state(ctx, 1), 77, 1.0, 0.5)[0]


@pytest.mark.parametrize("name,kw", [("pyramid_bislerp", {}),
                                     ("pyramid", {"upscale_mode": "adaptive_avg_pool2d"})])
def test_pyramid_composed_path_matches_jax_composition(numpy_draws, name, kw):
    shape = (1, 2, 24, 20)
    gen, got = _generate(name, shape, **kw)
    assert not TFP.fused_pyramid_supported(
        TG._size_ladder_pyramid(24, 20, gen.iterations, 0), 24, 20, gen.upscale_mode)
    base, *levels = numpy_draws.log
    sizes = JG._size_ladder_pyramid(24, 20, gen.iterations, gen.schedule_seed)
    assert [lv.shape[-2:] for lv in levels] == sizes
    want = jnp.asarray(base)
    for i, lv in enumerate(levels):
        want = want + j_scale_samples(jnp.asarray(lv), 20, 24, mode=gen.upscale_mode) * (
            gen.discount**i)
    _close(got, want, COMPOSE_TOL)


@pytest.mark.parametrize("name,kw,shape", [
    ("highres_pyramid", {"upscale_mode": "bicubic"}, (1, 2, 12, 10)),
    ("highres_pyramid_area", {}, (1, 2, 12, 10)),  # non-integer scales: no B5
    ("highres_pyramid_bislerp", {"iterations": 3}, (1, 2, 8, 8)),
])
def test_highres_composed_path_matches_jax_composition(numpy_draws, name, kw, shape):
    gen, got = _generate(name, shape, **kw)
    h, w = shape[-2:]
    sizes = JG._size_ladder_highres(h, w, gen.iterations, gen.schedule_seed)
    assert not TFP.fused_downscale_supported(sizes, h, w, gen.upscale_mode)
    base, *levels = numpy_draws.log
    assert [lv.shape[-2:] for lv in levels] == sizes
    want = (jnp.asarray(base) - 0.5) * 3.46
    for i, lv in enumerate(levels):
        want = want + j_scale_samples(jnp.asarray(lv), w, h, mode=gen.upscale_mode) * (
            gen.discount**i)
    _close(got, want, COMPOSE_TOL)


def test_pyramid_old_composed_path_matches_jax_composition(numpy_draws):
    gen, got = _generate("pyramid_old_bislerp", (1, 2, 6, 5), iterations=3)
    want = jnp.zeros((1, 2, 6, 5))
    for i, lv in enumerate(numpy_draws.log):
        assert lv.shape[-2:] == (6 * 2 ** (i + 1), 5 * 2 ** (i + 1))
        want = want + j_scale_samples(jnp.asarray(lv) * (0.5**i), 5, 6, mode="bislerp") * (
            0.8**i)
    _close(got, want, COMPOSE_TOL)


def test_kernel_paths_take_the_fused_plain_versions():
    """Where the gate holds, the generators draw what the B4/B5 plain
    versions draw for the same seeds."""
    ctx = NoiseCtx(shape=(1, 2, 16, 16), device="cpu")
    seed = 4242
    gen = get_noise_item("pyramid")
    got, _ = gen.generate(ctx, (), seed, 1.0, 0.5)
    sizes = TG._size_ladder_pyramid(16, 16, 10, 0)
    assert torch.equal(got, TFP.fused_pyramid_reference(seed, ctx.shape, sizes, 0.7,
                                                        device="cpu"))
    gen = get_noise_item("pyramid_old")
    got, _ = gen.generate(ctx, (), seed, 1.0, 0.5)
    sizes = [(16 * 2 ** (i + 1),) * 2 for i in range(5)]
    coefs = [(0.5**i) * 0.8**i for i in range(5)]
    assert torch.equal(got, TFP.fused_downscale_pyramid_reference(
        seed, ctx.shape, sizes, coefs, "nearest-exact", device="cpu"))
    gen = get_noise_item("highres_pyramid")
    got, _ = gen.generate(ctx, (), seed, 1.0, 0.5)
    base = (hwrng.philox_rand(derive_seed(seed, "inner"), ctx.shape, device="cpu") - 0.5) * 3.46
    sizes = TG._size_ladder_highres(16, 16, 4, 0)
    assert torch.equal(got, TFP.fused_downscale_pyramid_reference(
        derive_seed(seed, "draw"), ctx.shape, sizes, [0.7**i for i in range(len(sizes))],
        "bilinear", base=base, device="cpu"))


def test_five_d_latents_fold_frames():
    shape = (1, 2, 3, 16, 16)
    for name in ("pyramid", "highres_pyramid", "pyramid_old", "pyramid_mix"):
        fn, st = make_noise_sampler(get_noise_item(name), shape, seed=3, device="cpu")
        noise, _ = fn(st, 1.0, 0.5)
        assert noise.shape == shape and torch.isfinite(noise).all()
        fn4, st4 = make_noise_sampler(get_noise_item(name), (1, 6, 16, 16), seed=3,
                                      device="cpu")
        assert torch.equal(noise.reshape(1, 6, 16, 16), fn4(st4, 1.0, 0.5)[0])
    with pytest.raises(ValueError, match="at least 4"):
        make_noise_sampler(get_noise_item("pyramid"), (4, 16, 16), seed=0, device="cpu")


# ---------------------------------------------------------------------------
# The 13 registry names: statistics against the JAX package
# ---------------------------------------------------------------------------

STATS_SHAPE, DRAWS = (4, 4, 32, 32), 8
# independent streams: the margins of test_reference_noise_stats_oracle.py
_BAND_TOL = {"pyramid_old": 0.1, "pyramid_old_area": 0.1, "pyramid_old_bislerp": 0.1,
             "pyramid_bislerp": 0.08}


def _radial_band_fractions(batch: np.ndarray) -> np.ndarray:
    spec = np.abs(np.fft.fft2(batch.astype(np.float64), axes=(-2, -1))) ** 2
    h, w = batch.shape[-2:]
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fy**2 + fx**2) / np.sqrt(0.5)
    bands = np.asarray([spec[..., (r >= lo) & (r < hi)].sum()
                        for lo, hi in ((0.0, 0.33), (0.33, 0.66), (0.66, 1.01))])
    return bands / bands.sum()


@pytest.mark.parametrize("name", PYRAMID_NAMES)
def test_noise_type_statistics_match_jax(name):
    kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
    fn, st = make_noise_sampler(get_noise_item(name), STATS_SHAPE, device="cpu", **kw)
    jfn, jst = j_make_noise_sampler(j_get_noise_item(name), STATS_SHAPE, **kw)
    ours, theirs = [], []
    for _ in range(DRAWS):
        noise, st = fn(st, 1.0, 0.9)
        jnoise, jst = jfn(jst, jnp.asarray(1.0), jnp.asarray(0.9))
        ours.append(noise.numpy())
        theirs.append(np.asarray(jnoise))
    got, want = np.stack(ours), np.stack(theirs)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert abs(got.std() / want.std() - 1.0) < 0.15, (got.std(), want.std())
    assert abs(got.mean() - want.mean()) < 0.1
    diff = np.abs(_radial_band_fractions(got) - _radial_band_fractions(want)).max()
    assert diff < _BAND_TOL.get(name, 0.06), diff


def test_registry_presets_match_jax():
    for name in PYRAMID_NAMES:
        ours, theirs = get_noise_item(name), j_get_noise_item(name)
        assert type(ours).__name__ == type(theirs).__name__
        if name.startswith("pyramid_mix"):
            assert ours.mix_name == theirs.mix_name
            for (g, t), (jg, jt) in zip(ours._members(), theirs._members()):
                assert t == jt and (g.discount, g.upscale_mode) == (jg.discount,
                                                                     jg.upscale_mode)
            continue
        for k in ("discount", "upscale_mode", "iterations"):
            assert getattr(ours, k) == getattr(theirs, k), (name, k)
        assert ours.DEFAULT_NORMALIZED == theirs.DEFAULT_NORMALIZED
        assert (ours.MIN_DIMS, ours.MAX_DIMS) == (4, 5)


# ---------------------------------------------------------------------------
# The sonar sampler with pyramid noise
# ---------------------------------------------------------------------------


def _stub(shape):
    t = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape) / 100.0
    return lambda x, s, **_: (x * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)


@pytest.mark.parametrize("noise_type", ["pyramid", "highres_pyramid", "pyramid_old"])
def test_sampler_with_pyramid_noise_is_seeded_and_resumable(noise_type):
    shape = (1, 4, 16, 16)
    sig = torch.tensor([14.6, 6.0, 2.0, 0.5, 0.0])
    x0 = torch.from_numpy(_randn(np.random.default_rng(6), *shape)) * 14.6
    cfg = SonarConfig(noise_type=noise_type)
    model = _stub(shape)
    full = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=7, sonar_config=cfg)
    assert torch.isfinite(full).all() and full.shape == shape
    assert torch.equal(full, ts.sample_sonar_euler_ancestral(model, x0, sig, seed=7,
                                                             sonar_config=cfg))
    assert not torch.equal(full, ts.sample_sonar_euler_ancestral(model, x0, sig, seed=8,
                                                                 sonar_config=cfg))
    gauss = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=7)
    assert not torch.equal(full, gauss)
    _, carry = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=7, sonar_config=cfg,
                                               stop_step=2, return_state=True)
    resumed = ts.sample_sonar_euler_ancestral(model, x0, sig, seed=7, sonar_config=cfg,
                                              resume_from=carry, start_step=2)
    assert torch.equal(full, resumed)


def test_cpu_paths_count_no_launches():
    counters = (hwrng.philox_randn, hwrng.philox_rand, TFP.fused_pyramid,
                TFP.fused_downscale_pyramid, TFP.fused_pyramid_accumulate,
                TFP.fused_downscale_accumulate)
    before = [f.launches for f in counters]
    for name in ("pyramid", "highres_pyramid", "pyramid_old"):
        fn, st = make_noise_sampler(get_noise_item(name), (1, 4, 16, 16), seed=1,
                                    device="cpu")
        fn(st, 1.0, 0.5)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="no kernel"):
        TFP.fused_pyramid(0, (1, 1, 4, 4), [(4, 4)], 0.7, device="meta")


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
