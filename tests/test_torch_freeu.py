"""FreeU-Extreme in the port against the JAX package on the CPU: the three
spectral operators, the config logic, the patch handler's windows and
stages, and a patched narrow UNet (``model_channels`` 8, mult (1, 2, 4), so
8×8, 16×16 and 32×32 activations are stages 1, 2 and 3) whose weights are
carried across by ``unet_params_from_jax``.

The JAX side runs as its own tests run it (tests/test_cfg.py:405-530):
``SONAR_TPU_FREEU_MATMUL`` picks its operator ("0" the FFT, "1" dense K up
to 32×32, "sep" the factor pair beyond).

Tolerances, relative to max(1, |JAX|): dense K 3e-6 (one float32 product
of 256-1024 terms against JAX's HIGHEST-precision one), the factor pair
3e-5 (rank truncation at 1e-7 and two products), the FFT 1e-5 (pocketfft
against XLA's FFT in float32); the handler 1e-5; the patched UNet 1e-4
(convolutions sum in another order, as tests/test_torch_unet.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.cfg.freeu as jf
import sonar_tpu.models.unet as ju
import sonar_tpu_torch.cfg.freeu as tf
import sonar_tpu_torch.models.unet as tu
from sonar_tpu.cfg.model_sampling import DiscreteSampling as JDS
from sonar_tpu.cfg.model_sampling import Flow as JFlow
from sonar_tpu.noise.power import PowerFilter as JPF
from sonar_tpu_torch.cfg.model_sampling import DiscreteSampling as TDS
from sonar_tpu_torch.cfg.model_sampling import Flow as TFlow
from sonar_tpu_torch.noise.power import PowerFilter as TPF

DENSE_SHAPES = [(1, 8, 16, 16), (2, 4, 32, 32), (1, 4, 16, 24), (1, 4, 15, 17)]
SEP_SHAPES = [(1, 2, 64, 64), (1, 2, 48, 80), (1, 1, 128, 128)]
ASYM = dict(alpha=0.6, rotate=0.5, stretch=2.0, min_freq=0.05)
UNET_KW = dict(model_channels=8, channel_mult=(1, 2, 4), attention_levels=(2,), num_heads=2,
               norm_groups=4)


def _close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= rel * scale, (err, rel * scale)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_ffilter(monkeypatch, mode, x, filt_kw, norm):
    monkeypatch.setenv("SONAR_TPU_FREEU_MATMUL", mode)
    return np.asarray(jax.jit(lambda v: jf.ffilter(v, JPF(**filt_kw), norm))(jnp.asarray(x)))


def _port_ffilter(x, filt_kw, norm, operator):
    return tf.ffilter(torch.from_numpy(x), TPF(**filt_kw), norm, operator=operator).numpy()


# ---------------------------------------------------------------------------
# the three spectral operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_and_fft_match_jax(shape, monkeypatch):
    x, kw = _x(shape), dict(alpha=0.4)
    _close_rel(_port_ffilter(x, kw, 0.25, "dense"), _jax_ffilter(monkeypatch, "1", x, kw, 0.25),
               3e-6)
    fft_ref = _jax_ffilter(monkeypatch, "0", x, kw, 0.25)
    _close_rel(_port_ffilter(x, kw, 0.25, "fft"), fft_ref, 1e-5)
    # the three operators of the port agree with each other
    _close_rel(_port_ffilter(x, kw, 0.25, "dense"), _port_ffilter(x, kw, 0.25, "fft"), 3e-6)
    _close_rel(_port_ffilter(x, kw, 0.25, "sep"), _port_ffilter(x, kw, 0.25, "fft"), 3e-5)


@pytest.mark.parametrize("shape", SEP_SHAPES)
def test_sep_and_fft_match_jax_beyond_the_dense_gate(shape, monkeypatch):
    x, kw = _x(shape, 1), dict(alpha=0.4)
    _close_rel(_port_ffilter(x, kw, 0.25, "sep"), _jax_ffilter(monkeypatch, "sep", x, kw, 0.25),
               3e-5)
    fft = _port_ffilter(x, kw, 0.25, "fft")
    _close_rel(fft, _jax_ffilter(monkeypatch, "0", x, kw, 0.25), 1e-5)
    _close_rel(_port_ffilter(x, kw, 0.25, "sep"), fft, 3e-5)


def test_asymmetric_masks(monkeypatch):
    """rotate/stretch masks have a real antisymmetric part: the factor
    pair's Ms/Ma split must reproduce it."""
    x = _x((1, 3, 64, 64), 2)
    ref = _jax_ffilter(monkeypatch, "0", x, ASYM, 0.0)
    _close_rel(_port_ffilter(x, ASYM, 0.0, "fft"), ref, 1e-5)
    _close_rel(_port_ffilter(x, ASYM, 0.0, "sep"), ref, 3e-5)
    _close_rel(_port_ffilter(x, ASYM, 0.0, "sep"), _jax_ffilter(monkeypatch, "sep", x, ASYM, 0.0),
               3e-5)
    x16 = _x((1, 3, 16, 16), 3)
    _close_rel(_port_ffilter(x16, ASYM, 0.0, "dense"),
               _jax_ffilter(monkeypatch, "1", x16, ASYM, 0.0), 3e-6)


def test_default_operator_follows_the_shape():
    """Dense K up to 32×32, the FFT above, bit for bit the forced operator;
    the "_fast" variants equal the exact ones on the CPU (no TF32 there)."""
    kw = dict(alpha=0.4)
    for shape, want in (((1, 2, 32, 32), "dense"), ((1, 2, 16, 24), "dense"),
                        ((1, 2, 33, 32), "fft"), ((1, 2, 64, 64), "fft")):
        assert tf.default_operator(*shape[-2:]) == want
        x = _x(shape, 4)
        np.testing.assert_array_equal(_port_ffilter(x, kw, 0.25, None),
                                      _port_ffilter(x, kw, 0.25, want))
    # beyond 128x128 "sep" runs the FFT, as in the JAX package
    x = _x((1, 1, 136, 136), 4)
    np.testing.assert_array_equal(_port_ffilter(x, kw, 0.25, "sep"),
                                  _port_ffilter(x, kw, 0.25, "fft"))
    x = _x((1, 2, 16, 16), 5)
    for op in ("dense", "sep"):
        np.testing.assert_array_equal(_port_ffilter(x, kw, 0.25, op + "_fast"),
                                      _port_ffilter(x, kw, 0.25, op))
    with pytest.raises(ValueError, match="Unknown ffilter operator"):
        _port_ffilter(x, kw, 0.25, "matmul")


def test_operators_are_built_once_and_the_tf32_switch_is_restored():
    pf = TPF(alpha=0.3, scale=1.5)
    x = torch.from_numpy(_x((1, 2, 8, 8), 6))
    before = tf._operator_tensors.cache_info()
    for op in ("dense", "sep", "fft", "dense", "sep", "fft"):
        tf.ffilter(x, pf, 0.5, operator=op)
    after = tf._operator_tensors.cache_info()
    assert after.misses - before.misses == 3 and after.hits - before.hits == 3
    a = tf._operator_tensors(pf, 8, 8, 0.5, "dense", "cpu")
    assert a is tf._operator_tensors(pf, 8, 8, 0.5, "dense", "cpu")
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    try:
        for state in (True, False):
            flags.allow_tf32 = state
            tf.ffilter(x, pf, 0.5, operator="dense")
            tf.ffilter(x, pf, 0.5, operator="sep_fast")
            assert flags.allow_tf32 is state
    finally:
        flags.allow_tf32 = old


def test_bfloat16_activations_are_filtered_in_float32(monkeypatch):
    x = _x((1, 4, 16, 16), 7)
    xb = torch.from_numpy(x).bfloat16()
    out = tf.ffilter(xb, TPF(alpha=0.4), 0.25)
    assert out.dtype == torch.bfloat16
    want = tf.ffilter(xb.float(), TPF(alpha=0.4), 0.25).bfloat16()
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the config logic
# ---------------------------------------------------------------------------


def _chain(mod, pf):
    """A chain whose skipped links (start >= 1, blend 0, no stage) must drop
    out of get_config_list, in reverse order."""
    c = mod.FreeUExtremeConfig
    tail = c(start=0.2, end=0.8, scale=1.3, stage_2=True, sonar_power_filter=pf)
    tail = c(start=1.0, frux_config=tail)
    tail = c(blend=0.0, frux_config=tail)
    tail = c(stage_1=False, frux_config=tail)
    tail = c(target="skip", scale=0.9, slice=0.5, slice_offset=0.25, final=False,
             frux_config=tail)
    return c(target="both", scale=1.1, blend=0.5, blend_mode="inject", frux_config=tail)


def test_config_chains_match_jax():
    fields = ("target", "stage_1", "stage_2", "stage_3", "start", "end", "slice",
              "slice_offset", "filter_norm", "scale", "blend", "blend_mode", "hidden_mean",
              "final")
    got = _chain(tf, TPF(alpha=0.4)).get_config_list()
    want = _chain(jf, JPF(alpha=0.4)).get_config_list()
    assert [tuple(getattr(c, f) for f in fields) for c in got] == \
        [tuple(getattr(c, f) for f in fields) for c in want]
    assert len(got) == 3 and got[0].sonar_power_filter == TPF(alpha=0.4)


@pytest.mark.parametrize("hidden_mean", [True, False])
def test_get_scale_matches_jax(hidden_mean):
    h = _x((2, 6, 8, 8), 8)
    h[1] = 0.5  # a constant item: hmax == hmin
    jc = jf.FreeUExtremeConfig(scale=1.4, hidden_mean=hidden_mean)
    tc_ = tf.FreeUExtremeConfig(scale=1.4, hidden_mean=hidden_mean)
    want, got = jc.get_scale(jnp.asarray(h)), tc_.get_scale(torch.from_numpy(h))
    if not hidden_mean:
        assert got == want == 1.4
    else:
        _close_rel(got, want, 1e-6)


def test_stage_and_target_logic():
    for ch in (8, 16, 32, 24, 64, 4):
        assert tf._stage_of(ch, 8) == jf._stage_of(ch, 8)
    for target in ("backbone", "skip", "both"):
        t, j = tf.FreeUExtremeConfig(target=target), jf.FreeUExtremeConfig(target=target)
        for is_skip in (False, True):
            assert t.target_matches(is_skip) == j.target_matches(is_skip)
    t = tf.FreeUExtremeConfig(stage_1=False, stage_3=True)
    assert [t.stage_enabled(s) for s in (1, 2, 3)] == [False, False, True]


def _pct(sigma):
    return float(1.0 - JDS().timestep(jnp.float32(sigma)) / 999.0)


def _window_cases():
    edge = _pct(3.0)
    return [("inside", 3.0, 0.1, 0.9), ("start edge", 3.0, edge, 0.9),
            ("end edge", 3.0, 0.0, edge), ("before start", 3.0, edge + 1e-3, 1.0),
            ("after end", 3.0, 0.0, edge - 1e-3)]


@pytest.mark.parametrize("case", _window_cases(), ids=lambda c: c[0])
def test_window_matches_jax(case):
    """The percent-window gate inside, on the edge of and outside
    start/end (edges set to the float32 pct of sigma 3 itself)."""
    label, sigma, start, end = case
    kw = dict(target="both", stage_1=True, scale=1.3, slice=0.75,
              start=start, end=end)
    jp = jf.make_freeu_patches(model_sampling=JDS(), model_channels=8,
                               input_config=jf.FreeUExtremeConfig(
                                   sonar_power_filter=JPF(alpha=0.4), **kw))
    tp = tf.make_freeu_patches(model_sampling=TDS(), model_channels=8,
                               input_config=tf.FreeUExtremeConfig(
                                   sonar_power_filter=TPF(alpha=0.4), **kw))
    x = _x((1, 32, 16, 16), 9)
    want = np.asarray(jp["input"][0](jnp.asarray(x.transpose(0, 2, 3, 1)),
                                     {"sigma": jnp.asarray([sigma], jnp.float32)}))
    xt = torch.from_numpy(x)
    got = tp["input"][0](xt, {"sigma": torch.tensor([sigma])})
    _close_rel(got.numpy(), want.transpose(0, 3, 1, 2), 1e-5)
    inside = label in ("inside", "start edge", "end edge")
    assert torch.equal(got, xt) != inside


def test_final_shadowing_matches_jax():
    """A matched ``final`` config shadows the later ones; an out-of-window
    ``final`` one does not."""
    def chain(mod, pf, first_start):
        second = mod.FreeUExtremeConfig(stage_1=True, scale=0.8, slice=0.5,
                                        sonar_power_filter=pf)
        return mod.FreeUExtremeConfig(stage_1=True, scale=1.5, start=first_start,
                                      frux_config=second)

    x = _x((1, 32, 8, 8), 10)
    for first_start in (0.0, 0.99):
        jp = jf.make_freeu_patches(model_sampling=JDS(), model_channels=8,
                                   middle_config=chain(jf, JPF(alpha=0.4), first_start))
        tp = tf.make_freeu_patches(model_sampling=TDS(), model_channels=8,
                                   middle_config=chain(tf, TPF(alpha=0.4), first_start))
        want = jp["middle"][0](jnp.asarray(x.transpose(0, 2, 3, 1)),
                               {"sigma": jnp.asarray([2.0])})
        got = tp["middle"][0](torch.from_numpy(x), {"sigma": torch.tensor([2.0])})
        _close_rel(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), 1e-5)


def test_skip_stage_comes_from_the_backbone():
    """At a channel-transition output block the skip tensor is staged by the
    backbone's channel count, not its own (freeu_extreme.py:311-313)."""
    cfg = dict(target="skip", stage_1=False, stage_2=True, scale=1.5, hidden_mean=False)
    jp = jf.make_freeu_patches(model_sampling=JDS(), model_channels=8,
                               output_config=jf.FreeUExtremeConfig(**cfg))
    tp = tf.make_freeu_patches(model_sampling=TDS(), model_channels=8,
                               output_config=tf.FreeUExtremeConfig(**cfg))
    h, hsp = _x((1, 16, 8, 8), 11), _x((1, 32, 8, 8), 12)  # backbone stage 2, skip "stage 1"
    jh, jsp = jp["output"][0](jnp.asarray(h.transpose(0, 2, 3, 1)),
                              jnp.asarray(hsp.transpose(0, 2, 3, 1)),
                              {"sigma": jnp.asarray([1.0])})
    th, tsp = tp["output"][0](torch.from_numpy(h), torch.from_numpy(hsp),
                              {"sigma": torch.tensor([1.0])})
    np.testing.assert_array_equal(th.numpy(), h)
    _close_rel(tsp.numpy(), np.asarray(jsp).transpose(0, 3, 1, 2), 1e-6)
    np.testing.assert_allclose(tsp.numpy(), hsp * 1.5, rtol=1e-6)


# ---------------------------------------------------------------------------
# the patched UNet
# ---------------------------------------------------------------------------


def _randomized(params, seed=0):
    """Every leaf redrawn at full scale (the JAX init zeroes biases and
    shrinks output convs, which would hide a mapping or hook error)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree.flatten(params)
    out = []
    for leaf in flat:
        if leaf.ndim >= 2:
            out.append(rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1])))
        else:
            out.append(0.1 * rng.standard_normal(leaf.shape) + (0.0 if leaf.sum() == 0 else 1.0))
    return jax.tree.unflatten(treedef, [np.asarray(a, np.float32) for a in out])


@pytest.fixture(scope="module")
def unets():
    jcfg = ju.UNetConfig(**UNET_KW)
    params = _randomized(jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0),
                                                                        jcfg))
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    return jcfg, params, model.eval()


def _configs(mod, pf):
    """Every stage, both targets, a window, a chain and the middle block."""
    c = mod.FreeUExtremeConfig
    inp = c(target="both", stage_1=True, stage_2=True, scale=1.12, slice=0.75,
            sonar_power_filter=pf,
            frux_config=c(stage_1=False, stage_3=True, scale=0.9, slice=0.5, start=0.3,
                          end=0.95, sonar_power_filter=pf))
    mid = c(stage_1=True, scale=1.2, hidden_mean=False, sonar_power_filter=pf, filter_norm=0.5)
    out = c(target="both", stage_1=True, stage_2=True, stage_3=True, scale=1.1, blend=0.7,
            sonar_power_filter=pf)
    return dict(input_config=inp, middle_config=mid, output_config=out)


@pytest.mark.parametrize("mode,operator", [("1", None), ("0", "fft")])
def test_patched_unet_matches_jax(unets, mode, operator, monkeypatch):
    jcfg, params, model = unets
    jp = jf.make_freeu_patches(model_sampling=JDS(), model_channels=8,
                               **_configs(jf, JPF(alpha=0.4)))
    tp = tf.make_freeu_patches(model_sampling=TDS(), model_channels=8, operator=operator,
                               **_configs(tf, TPF(alpha=0.4)))
    x = _x((1, 4, 32, 32), 13) * 3.0
    sigma = np.asarray([2.5], np.float32)
    monkeypatch.setenv("SONAR_TPU_FREEU_MATMUL", mode)
    want = jax.jit(lambda xi, si: ju.unet_apply(params, xi, si, jcfg, block_patches=jp))(
        jnp.asarray(x), jnp.asarray(sigma))
    plain = np.asarray(jax.jit(lambda xi, si: ju.unet_apply(params, xi, si, jcfg))(
        jnp.asarray(x), jnp.asarray(sigma)))
    with torch.no_grad():
        got = tu.unet_apply(model, torch.from_numpy(x), torch.from_numpy(sigma),
                            block_patches=tp)
    _close_rel(got.numpy(), want, 1e-4)
    assert np.abs(np.asarray(want) - plain).max() > 1e-2  # the patches did act


def test_patched_denoiser_sees_the_true_sigma(unets):
    """``make_denoiser`` with a flow timestep (the network conditioned on
    sigma·1000): the patches' window is read on the true sigma."""
    jcfg, params, model = unets
    kw = dict(target="backbone", stage_1=True, scale=1.4, start=0.2, end=0.8)
    jp = jf.make_freeu_patches(model_sampling=JFlow(), model_channels=8,
                               input_config=jf.FreeUExtremeConfig(**kw))
    tp = tf.make_freeu_patches(model_sampling=TFlow(), model_channels=8,
                               input_config=tf.FreeUExtremeConfig(**kw))
    jd = ju.make_denoiser(params, jcfg, block_patches=jp, prediction="flow",
                          timestep_fn=JFlow().timestep)
    td = tu.make_denoiser(model, block_patches=tp, prediction="flow",
                          timestep_fn=TFlow().timestep)
    tplain = tu.make_denoiser(model, prediction="flow", timestep_fn=TFlow().timestep)
    x = _x((1, 4, 32, 32), 14)
    for s, inside in ((0.5, True), (0.9, False)):
        sig = np.asarray([s], np.float32)
        got = td(torch.from_numpy(x), torch.from_numpy(sig))
        _close_rel(got.numpy(), jd(jnp.asarray(x), jnp.asarray(sig)), 1e-4)
        same = torch.equal(got, tplain(torch.from_numpy(x), torch.from_numpy(sig)))
        assert same != inside


def test_patching_keeps_the_skip_stack(unets):
    """The skip stack holds the tensors the input patches returned, and no
    patch writes into a tensor it was given."""
    _, _, model = unets
    tp = tf.make_freeu_patches(model_sampling=TDS(), model_channels=8,
                               **_configs(tf, TPF(alpha=0.4)))
    pushed, seen = [], []

    def record_input(h, ctx):
        out = tp["input"][0](h, ctx)
        pushed.append((out, out.clone()))
        return out

    def record_output(h, hsp, ctx):
        seen.append(hsp)
        return tp["output"][0](h, hsp, ctx)

    x = torch.from_numpy(_x((1, 4, 32, 32), 15))
    with torch.no_grad():
        got = model(x, torch.tensor([2.5]), block_patches={
            "input": [record_input], "middle": tp["middle"], "output": [record_output]})
        want = model(x, torch.tensor([2.5]), block_patches=tp)
    assert torch.equal(got, want)
    assert len(seen) == len(pushed) == 6  # conv_in, 3 blocks, 2 downsamples
    for hsp, (out, copy) in zip(seen, reversed(pushed)):
        assert hsp is out and torch.equal(out, copy)


def test_no_patches_is_the_plain_forward(unets):
    _, _, model = unets
    x, s = torch.from_numpy(_x((1, 4, 32, 32), 16)), torch.tensor([4.0])
    with torch.no_grad():
        plain = model(x, s)
        identity = {"input": [lambda h, ctx: h], "middle": [lambda h, ctx: h],
                    "output": [lambda h, hsp, ctx: (h, hsp)]}
        for patches in (None, {}, identity):
            assert torch.equal(model(x, s, block_patches=patches), plain)
