"""The rest of the noise zoo in the port against the JAX package: Perlin,
Student-t, green_test, pink_old, power_old, OneF, the power-law family and
Laplacian; the 17 registry names they make; ``register_noise_type`` and
``noise_type_names``; ``CustomNoiseParametersNoise`` (config 5's 5D
frames-to-channels wrapper).

The two packages draw from different streams (Philox here, threefry
there), so each generator's deterministic part is held on shared numpy
draws: the JAX generators' ``jax`` (and ``sonar_tpu.core.rng``'s, for the
Student-t uniforms) is replaced by a stand-in whose ``random`` functions
hand out a table's draws in call order, and the port's Philox wrappers are
replaced the same way. Both sides must ask for the same draws in the same
order. JAX's uniform(minval, maxval) and laplace transforms are applied to
the shared uniforms as ``jax.random`` applies them.

Tolerances: shared draws 1e-5 relative to max(1, |JAX|) (FFTs, quantiles,
pow and scale_noise's sums in another order); the random parts by
statistics of the port's own stream: KS tests at p > 0.01 (n = 200,000),
moments of independent draws within 3 % of the JAX package's, radial power
spectra band by band within 15 %.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import sonar_tpu.core.rng as JR
import sonar_tpu.noise as jn
import sonar_tpu.noise.generators as JG
import sonar_tpu.noise.presets as JP
import sonar_tpu_torch.core.rng as TR
import sonar_tpu_torch.noise.generators as TG
import sonar_tpu_torch.noise.presets as TP
from sonar_tpu.noise.base import NoiseCtx as JCtx
from sonar_tpu.noise.base import NoiseItem as JItem
from sonar_tpu_torch.core.rng import derive_seed, draw_laplace, seed_from, studentt_polar
from sonar_tpu_torch.noise import (CustomNoiseParametersNoise, NoiseCtx, NoiseItem,
                                   NoiseSamplerHandle, get_noise_item, make_noise_sampler,
                                   noise_type_names, register_noise_type)
from sonar_tpu_torch.noise.power import PowerNoiseItem

NEW_NAMES = ["perlin", "studentt", "pink_old", "power_old", "laplacian", "green_test",
             "onef_pinkish", "onef_greenish", "onef_pinkishgreenish", "onef_pinkish_mix",
             "onef_greenish_mix", "white", "grey", "velvet", "violet", "rainbow_mild",
             "rainbow_intense"]
# the classes at their presets' parameters: onef at alpha 2 and powerlaw at
# alpha 2 (x³) put their moments in a few low frequencies or far tails,
# where two streams' sample moments differ by more than the margin
NEW_CLASSES = [("perlin_old", {}), ("studentt", {}), ("green_test", {}), ("pink_old", {}),
               ("power_old", {}), ("onef", {"alpha": 0.5}), ("onef", {"alpha": -0.5}),
               ("powerlaw", {"alpha": 0.5, "use_sign": True}), ("laplacian", {})]
REL = 1e-5


def _close_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= rel * scale, (err, rel * scale)


class _Table:
    """The i-th draw asked of the table: normals or uniforms in [0, 1) of the
    asked shape, from numpy seeded by (seed, i); the calls are recorded."""

    def __init__(self, seed=0):
        self.seed, self.calls = seed, []

    def draw(self, kind, shape):
        shape = tuple(int(d) for d in shape)
        rng = np.random.default_rng([self.seed, len(self.calls)])
        self.calls.append((kind, shape))
        if kind == "normal":
            return rng.standard_normal(shape).astype(np.float32)
        return rng.random(shape, dtype=np.float32)


class _FakeRandom:
    """``jax.random`` on a table: the draws ignore their keys (keys are made
    as jax.random makes them), the transforms are jax.random's own
    (uniform: max(lo, u·(hi - lo) + lo); laplace: sign(u)·log1p(-|u|) on u
    in [-1 + epsneg, 1))."""

    def __init__(self, table):
        self.table = table

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def split(self, key, num=2):
        return [key] * num

    def fold_in(self, key, data):
        return key

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.table.draw("normal", shape), dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.asarray(self.table.draw("uniform", shape), dtype)
        lo, hi = jnp.asarray(minval, dtype), jnp.asarray(maxval, dtype)
        return jnp.maximum(lo, u * (hi - lo) + lo)

    def laplace(self, key, shape=(), dtype=jnp.float32):
        u = self.uniform(key, shape, dtype, minval=-1.0 + jnp.finfo(dtype).epsneg, maxval=1.0)
        return jax.lax.mul(jax.lax.sign(u), jax.lax.log1p(jax.lax.neg(jax.lax.abs(u))))


class _FakeJax:
    def __init__(self, table):
        self.random = _FakeRandom(table)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def shared(monkeypatch):
    """Both packages drawing from tables of one seed; yields the tables."""
    jt, tt = _Table(3), _Table(3)
    fake = _FakeJax(jt)
    monkeypatch.setattr(JG, "jax", fake)
    monkeypatch.setattr(JR, "jax", fake)

    def draw(kind):
        def fn(seed, shape, *, device, dtype=torch.float32, stream=0):
            return torch.from_numpy(tt.draw(kind, shape)).to(device=device, dtype=dtype)
        return fn

    monkeypatch.setattr(TG, "philox_randn", draw("normal"))
    monkeypatch.setattr(TG, "philox_rand", draw("uniform"))
    monkeypatch.setattr(TR, "philox_rand", draw("uniform"))
    return jt, tt


def _hooked_pair(jgen, tgen, shape, shared):
    """Both generators through ``hooked`` (their class-default internal
    normalization) on the shared tables."""
    jt, tt = shared
    jctx, tctx = JCtx(shape=shape), NoiseCtx(shape=shape, device="cpu")
    want, _ = jgen.hooked(jctx, jgen.init_state(jctx, jax.random.key(0)), jax.random.key(1),
                          jnp.float32(1.0), jnp.float32(0.5))
    got, _ = tgen.hooked(tctx, tgen.init_state(tctx, 0), 1, 1.0, 0.5)
    assert tt.calls == jt.calls and tt.calls
    return got, np.asarray(want)


# ---------------------------------------------------------------------------
# deterministic parts on shared draws
# ---------------------------------------------------------------------------

GEN_CASES = [
    ("perlin_old", {}, (2, 4, 16, 16)),
    ("perlin_old", {"iterations": 3, "div_fac": 3.0, "blend_mode": "inject"}, (1, 3, 8, 12)),
    ("perlin_old", {}, (1, 2, 3, 8, 12)),
    ("studentt", {}, (2, 4, 16, 16)),
    ("studentt", {"df": 3.0, "quantile_fac": 0.9, "pow_fac": 0.7, "loc": 0.1}, (2, 3, 8, 8)),
    ("green_test", {}, (2, 4, 16, 16)),
    ("green_test", {"x_pow": 4, "power_base": 2.0}, (1, 2, 3, 8, 12)),
    ("pink_old", {"alpha": 1.5, "freq": 2.0}, (2, 4, 8, 8)),
    ("power_old", {}, (3, 4, 8, 8)),
    ("power_old", {"alpha": 1.0, "k": 2.0}, (2, 2, 3, 8, 8)),
    ("onef", {}, (2, 4, 16, 16)),
    ("onef", {"alpha": -0.5, "hfac": 2.0, "use_sqrt": False}, (1, 4, 16, 12)),
    ("onef", {"alpha": 0.5, "k": 0.0}, (1, 2, 3, 8, 8)),
    ("powerlaw", {}, (2, 4, 8, 8)),
    ("powerlaw", {"alpha": 0.5, "use_sign": True, "div_max_dims": (-2, -1),
                  "use_div_max_abs": False}, (2, 4, 8, 8)),
    ("laplacian", {}, (2, 4, 16, 16)),
    ("laplacian", {"loc": 0.5, "scale": 2.0, "div_fac": 2.0}, (1, 4, 8, 8)),
]


@pytest.mark.parametrize("name,kw,shape", GEN_CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(GEN_CASES)])
def test_generator_matches_jax_on_shared_draws(name, kw, shape, shared):
    jgen, tgen = JG.GENERATOR_CLASSES[name](**kw), TG.GENERATOR_CLASSES[name](**kw)
    got, want = _hooked_pair(jgen, tgen, shape, shared)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _close_rel(got, want)
    # and unnormalized: the generate step alone
    jt, tt = shared
    jt.calls.clear(), tt.calls.clear()
    jgen.gen_normalized = tgen.gen_normalized = False
    got, want = _hooked_pair(jgen, tgen, shape, shared)
    _close_rel(got, want)


@pytest.mark.parametrize("name", NEW_NAMES)
def test_presets_match_jax_on_shared_draws(name, shared):
    got, want = _hooked_pair(JP.get_noise_item(name), TP.get_noise_item(name), (2, 4, 16, 16),
                             shared)
    _close_rel(got, want)


@pytest.mark.parametrize("grid,out,batch", [((4, 4), (16, 16), 2), ((2, 3), (8, 12), 1),
                                            ((8, 6), (8, 12), 3)])
def test_perlin_noise_matches_jax(grid, out, batch, shared):
    """Cells larger than a pixel (the generator only uses one-pixel cells)."""
    jt, tt = shared
    want = JG.perlin_noise(jax.random.key(0), grid, out, batch_size=batch)
    got = TG.perlin_noise(0, grid, out, batch_size=batch, device="cpu")
    assert tt.calls == jt.calls == [("uniform", (batch, grid[0] + 1, grid[1] + 1))]
    _close_rel(got, want)


def test_studentt_and_laplace_draws_match_jax(shared):
    want = np.asarray(JR.studentt_polar(jax.random.key(0), 2.5, (4, 300), jnp.float32))
    got = studentt_polar(0, 2.5, (4, 300), device="cpu")
    _close_rel(got, want)
    want = np.asarray(_FakeRandom(shared[0]).laplace(None, (4, 300)))
    got = draw_laplace(0, (4, 300), device="cpu")
    _close_rel(got, want)
    assert shared[1].calls == shared[0].calls


def test_class_constants_match_jax():
    assert sorted(TG.GENERATOR_CLASSES) == sorted(JG.GENERATOR_CLASSES)
    for name, jcls in JG.GENERATOR_CLASSES.items():
        tcls = TG.GENERATOR_CLASSES[name]
        assert (tcls.DEFAULT_NORMALIZED, tcls.MIN_DIMS, tcls.MAX_DIMS) == (
            jcls.DEFAULT_NORMALIZED, jcls.MIN_DIMS, jcls.MAX_DIMS), name
        assert tcls.ng_params() == jcls.ng_params(), name


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_names_and_parameters_match_jax():
    jnames = list(JP.noise_type_names())
    tnames = list(noise_type_names())
    assert len(tnames) == 38
    assert tnames == jnames
    assert list(noise_type_names(default=None, skip=("perlin",))) == \
        [n for n in sorted(tnames) if n != "perlin"]
    for name in NEW_NAMES:
        j, t = JP.get_noise_item(name, factor=0.7), get_noise_item(name, factor=0.7)
        assert type(t).__name__ == type(j).__name__ and t.factor == 0.7
        if type(t).__name__ == "MixedGenerator":
            assert t.output_fun == j.output_fun and t.mix_name == j.mix_name
            assert [(type(g).__name__, g.params(), tr) for g, tr in t.noise_mix] == \
                [(type(g).__name__, g.params(), tr) for g, tr in j.noise_mix]
        else:
            assert t.params() == j.params()


def test_register_noise_type(monkeypatch):
    monkeypatch.setattr(TP, "NOISE_TYPES", dict(TP.NOISE_TYPES))
    register_noise_type("my_noise", lambda factor=1.0, normalize=None, **kw:
                        TG.PowerLawGenerator(factor, normalize=normalize, alpha=0.25, **kw))
    item = get_noise_item("my_noise", factor=0.5)
    assert isinstance(item, TG.PowerLawGenerator) and item.alpha == 0.25 and item.factor == 0.5
    assert "my_noise" in list(noise_type_names())
    with pytest.raises(ValueError, match="Unknown noise type 'no_such_noise'"):
        get_noise_item("no_such_noise")
    for name in ("distro", "collatz"):  # the generators of modules of their own
        j, t = JP.get_noise_item(name, factor=0.7), get_noise_item(name, factor=0.7)
        assert type(t).__name__ == type(j).__name__ and t.factor == 0.7
        assert {k: v for k, v in t.params().items() if k != "noise_dtype"} == \
            {k: v for k, v in j.params().items() if k != "noise_dtype"}


# ---------------------------------------------------------------------------
# the random parts, by statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("df", [1.0, 3.0, 30.0])
def test_studentt_polar_matches_the_t_cdf(df):
    x = studentt_polar(int(df * 7 + 1), df, (200_000,), device="cpu").numpy()
    assert st.kstest(x, "t", args=(df,)).pvalue > 0.01


def test_laplace_matches_the_laplace_cdf():
    x = draw_laplace(0, (200_000,), device="cpu").numpy()
    assert st.kstest(x, "laplace").pvalue > 0.01
    assert st.kstest(studentt_polar(0, 3.0, (200_000,), device="cpu").numpy(),
                     "laplace").pvalue < 1e-6  # the test can tell the two apart


def test_narrow_types_compute_in_float32():
    for fn in (lambda dt: studentt_polar(9, 2.0, (64, 64), dt, device="cpu"),
               lambda dt: draw_laplace(9, (64, 64), dt, device="cpu")):
        assert torch.equal(fn(torch.bfloat16), fn(torch.float32).bfloat16())


@pytest.mark.parametrize("name", NEW_NAMES)
def test_presets_normalized_stats(name):
    ns = NoiseSamplerHandle(get_noise_item(name), (2, 4, 32, 32), device="cpu",
                            sigma_min=0.03, sigma_max=15.0, seed=7)
    n = ns(1.0, 0.8).numpy()
    assert n.shape == (2, 4, 32, 32) and np.isfinite(n).all()
    assert abs(n.mean()) < 0.05 and abs(n.std(ddof=1) - 1) < 0.05
    assert not np.array_equal(n, ns(1.0, 0.8).numpy())


@pytest.mark.parametrize("name,kw", NEW_CLASSES, ids=[f"{n}-{kw}" for n, kw in NEW_CLASSES])
def test_unnormalized_moments_match_jax(name, kw):
    """Independent streams: mean, std and excess kurtosis of the raw draws."""
    shape = (4, 4, 64, 64)
    jfn, jst = jn.make_noise_sampler(JG.GENERATOR_CLASSES[name](**kw), shape, seed=2,
                                     normalized=False)
    want = np.asarray(jfn(jst, 1.0, 0.5)[0], np.float64).ravel()
    tfn, tst = make_noise_sampler(TG.GENERATOR_CLASSES[name](**kw), shape, device="cpu",
                                  seed=2, normalized=False)
    got = tfn(tst, 1.0, 0.5)[0].double().numpy().ravel()
    sj = want.std()
    assert abs(got.mean() - want.mean()) < 0.03 * sj + 1e-6
    assert abs(got.std() / sj - 1) < 0.03
    kj, kt = st.kurtosis(want), st.kurtosis(got)
    assert abs(kt - kj) < 0.1 * max(1.0, abs(kj)), (kt, kj)


def _radial(noise):
    """Mean |FFT|² over the batch and channel axes in five radial bands."""
    n = np.asarray(noise, np.float64)
    h, w = n.shape[-2:]
    p = (np.abs(np.fft.fft2(n)) ** 2).reshape(-1, h, w).mean(0)
    r = np.hypot(*np.meshgrid(np.fft.fftfreq(h), np.fft.fftfreq(w), indexing="ij"))
    edges = np.linspace(0.0, 0.5, 6)
    return np.array([p[(r > lo) & (r <= hi)].mean() for lo, hi in zip(edges, edges[1:])])


@pytest.mark.parametrize("name", ["onef_pinkish", "onef_greenish", "green_test", "perlin",
                                  "rainbow_mild"])
def test_radial_spectra_match_jax(name):
    shape = (4, 4, 64, 64)
    jfn, jst = jn.make_noise_sampler(JP.get_noise_item(name), shape, seed=4)
    tfn, tst = make_noise_sampler(get_noise_item(name), shape, device="cpu", seed=4)
    want, got = _radial(jfn(jst, 1.0, 0.5)[0]), _radial(tfn(tst, 1.0, 0.5)[0].numpy())
    np.testing.assert_allclose(got, want, rtol=0.15)


def test_onef_spectrum_slope():
    """alpha +0.5 (greenish) boosts low spatial frequencies, -0.5 (pinkish)
    high ones (the reference's k/power inversion)."""
    def bands(name):
        n = NoiseSamplerHandle(get_noise_item(name), (1, 4, 64, 64), device="cpu",
                               seed=0)(1.0, 0.5).numpy()[0]
        spec = np.abs(np.fft.fft2(n)) ** 2
        return spec[:, 1:4, 1:4].mean(), spec[:, 28:36, 28:36].mean()

    lo, hi = bands("onef_greenish")
    assert lo > hi * 1.5
    lo, hi = bands("onef_pinkish")
    assert hi > lo * 1.5


# ---------------------------------------------------------------------------
# CustomNoiseParametersNoise
# ---------------------------------------------------------------------------


class _Fixed(NoiseItem):
    """A child that hands out a given tensor (with NaN and ±inf in it)."""

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        return self.value.reshape(ctx.shape).to(ctx.dtype), state


class _JFixed(JItem):
    def sample(self, ctx, state, key, sigma, sigma_next, *, normalized=True):
        return self.value.reshape(ctx.shape).astype(ctx.dtype), state


CUSTOM_CASES = [  # (label, wrapper options, child class, shape)
    ("frames", dict(frames_to_channels=True), "green_test", (1, 2, 3, 8, 8)),
    ("frames add", dict(frames_to_channels=True, rng_offset_mode="add", rng_state_offset=5),
     "onef", (2, 2, 3, 8, 8)),
    ("square", dict(ensure_square_aspect_ratio=True), "green_test", (1, 2, 8, 18)),
    ("square frames", dict(frames_to_channels=True, ensure_square_aspect_ratio=True),
     "perlin_old", (1, 2, 2, 6, 24)),
    ("override", dict(rng_offset_mode="override", rng_state_offset=11, factor=0.5,
                      normalize=False), "laplacian", (1, 4, 8, 8)),
    # a bf16 child whose draw both packages round alike (Student-t and
    # Laplace compute in float32 in the port, in bf16 in the JAX package)
    ("bf16", dict(override_dtype=True), "pink_old", (1, 4, 8, 8)),
]


@pytest.mark.parametrize("case", CUSTOM_CASES, ids=lambda c: c[0])
def test_custom_noise_parameters_matches_jax(case, shared):
    _, kw, child, shape = case
    kw = dict(kw)
    bf16 = kw.pop("override_dtype", False)
    jitem = jn.CustomNoiseParametersNoise(noise=JG.GENERATOR_CLASSES[child](),
                                          override_dtype=jnp.bfloat16 if bf16 else None, **kw)
    titem = CustomNoiseParametersNoise(noise=TG.GENERATOR_CLASSES[child](),
                                       override_dtype=torch.bfloat16 if bf16 else None, **kw)
    jfn, jst = jn.make_noise_sampler(jitem, shape, seed=1)
    tfn, tst = make_noise_sampler(titem, shape, device="cpu", seed=1)
    for _ in range(2):
        want, jst = jfn(jst, 2.0, 1.0)
        got, tst = tfn(tst, 2.0, 1.0)
        assert got.shape == shape and got.dtype == torch.float32
        _close_rel(got, np.asarray(want))
    if kw.get("rng_offset_mode") == "override":
        assert tst["node"]["_rng_i"] == 2


def test_custom_noise_fix_invalid_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((1, 2, 3, 4, 4)).astype(np.float32)
    v.flat[[3, 17, 40, 77]] = [np.nan, np.inf, -np.inf, np.nan]
    kw = dict(frames_to_channels=True, fix_invalid=True, normalize=False)
    jitem = jn.CustomNoiseParametersNoise(noise=_JFixed(value=jnp.asarray(v)), **kw)
    titem = CustomNoiseParametersNoise(noise=_Fixed(value=torch.from_numpy(v)), **kw)
    want = jn.make_noise_sampler(jitem, v.shape, seed=0)[0](
        jn.make_noise_sampler(jitem, v.shape, seed=0)[1], 1.0, 0.5)[0]
    tfn, tst = make_noise_sampler(titem, v.shape, device="cpu", seed=0)
    got = tfn(tst, 1.0, 0.5)[0]
    assert bool(torch.isfinite(got).all())
    _close_rel(got, np.asarray(want), 1e-6)


def test_custom_noise_rng_offset_modes_are_seed_derivations():
    shape = (1, 2, 3, 8, 8)

    def draws(seed, **kw):
        item = CustomNoiseParametersNoise(noise=get_noise_item("gaussian"),
                                          frames_to_channels=True, **kw)
        fn, state = make_noise_sampler(item, shape, device="cpu", seed=seed, normalized=False)
        out = []
        for _ in range(2):
            n, state = fn(state, 1.0, 0.5)
            out.append(n)
        return out

    # "disabled": the child's 4D draw at the sampler's seed, folded back
    child = make_noise_sampler(get_noise_item("gaussian"), (1, 6, 8, 8), device="cpu",
                               seed=4, normalized=False)
    want = child[0](child[1], 1.0, 0.5)[0].reshape(shape)
    plain = draws(4)
    assert torch.equal(plain[0], want)
    # "add": another stream, derived from the same seed with the offset
    added = draws(4, rng_offset_mode="add", rng_state_offset=9)
    draw_seed = derive_seed(derive_seed(seed_from(4), 0), 9)
    assert torch.equal(added[0], TG.philox_randn(draw_seed, (1, 6, 8, 8),
                                                 device="cpu").reshape(shape))
    assert not torch.equal(added[0], plain[0])
    # "override": the offset's own stream, whatever the seed, advancing per draw
    a, b = draws(4, rng_offset_mode="override", rng_state_offset=9), draws(
        5, rng_offset_mode="override", rng_state_offset=9)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[0], a[1])
    assert torch.equal(a[0], TG.philox_randn(derive_seed(seed_from(9), 0), (1, 6, 8, 8),
                                             device="cpu").reshape(shape))
    # override_device and rng_mode change nothing
    assert torch.equal(draws(4, override_device="cpu", rng_mode="separate")[0], plain[0])


def test_config5_video_noise_folds_frames_into_channels():
    """Config 5: 16-frame time-Brownian power noise with frames folded into
    channels (tools/bench_configs.py:129-140), at 1×4×4×16×16 here: the
    draw is the 4D power noise's, reshaped."""
    shape, folded = (1, 4, 4, 16, 16), (1, 16, 16, 16)
    kw = dict(alpha=0.5, min_freq=0.05, time_brownian=True)
    item = CustomNoiseParametersNoise(noise=PowerNoiseItem(**kw), frames_to_channels=True)
    sk = dict(device="cpu", seed=3, sigma_min=0.03, sigma_max=14.6)
    fn, state = make_noise_sampler(item, shape, **sk)
    ref_fn, ref_state = make_noise_sampler(PowerNoiseItem(**kw), folded, **sk)
    # the wrapper's child is initialised on derive_seed(init seed, 0)
    ref_state = {**ref_state, "node": PowerNoiseItem(**kw).init_state(
        NoiseCtx(shape=folded, device="cpu", sigma_min=0.03, sigma_max=14.6),
        derive_seed(derive_seed(seed_from(3), "init"), 0))}
    for s, sn in ((14.0, 9.0), (9.0, 4.0), (4.0, 1.0)):
        n, state = fn(state, s, sn)
        r, ref_state = ref_fn(ref_state, s, sn)
        assert n.shape == shape and bool(torch.isfinite(n).all())
        assert torch.equal(n, r.reshape(shape))
        # scale_noise's dead band: mean and std are left alone within 2.5/sqrt(N)
        band = 2.5 / math.sqrt(n.numel())
        assert abs(float(n.mean())) <= band and abs(float(n.std()) - 1) <= band
    with pytest.raises(ValueError, match="at most 4"):
        make_noise_sampler(PowerNoiseItem(**kw), shape, **sk)
    assert math.prod(shape) == math.prod(folded)
