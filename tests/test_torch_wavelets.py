"""The port's wavelets (``sonar_tpu_torch.wavelets``) against the JAX
package's, on the CPU.

Tolerance: 1e-5 relative to max(1, |jax|) for every coefficient and every
reconstruction (float32 products and sums in another order than XLA's
convolutions; the replicate padding grows coefficients past 100 at level 3,
hence relative), and perfect reconstruction of the input within 1e-5
relative. Filter banks are one numpy module copied: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.wavelets as jw
import sonar_tpu.wavelets.coeffs as jcoeffs
import sonar_tpu_torch.wavelets as tw
import sonar_tpu_torch.wavelets.coeffs as tcoeffs

TOL = 1e-5
WAVES = ["haar", "db4", "sym8", "bior2.2"]
MODES = ["zero", "constant", "replicate", "symmetric", "reflect", "periodic", "periodization"]


def _close(t, j, tol=TOL):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    err, scale = float(np.abs(t - j).max()), max(1.0, float(np.abs(j).max()))
    assert err <= tol * scale, (err, tol * scale)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wave", WAVES)
def test_dwt2d_and_inverse_match_jax(wave, mode):
    """Level 3 on an odd 13×9 latent: every level's bands (the deepest are
    shorter than the filter, n < L - 1, for db4 and sym8) and the inverse."""
    shape, x = (2, 3, 13, 9), _x((2, 3, 13, 9))
    run = jax.jit(lambda v: (jw.dwt2d(v, wave, 3, mode),
                             jw.idwt2d(*jw.dwt2d(v, wave, 3, mode), wave, mode,
                                       out_hw=shape[-2:])))
    (jl, jh), jrec = run(jnp.asarray(x))
    tl, th = tw.dwt2d(torch.from_numpy(x), wave, 3, mode)
    _close(tl, jl)
    assert len(th) == len(jh) == 3
    for a, b in zip(th, jh):
        assert a.shape[2] == 3
        _close(a, b)
    rec = tw.idwt2d(tl, th, wave, mode, out_hw=shape[-2:])
    _close(rec, jrec)
    _close(rec, x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("level", [1, 2])
def test_dwt2d_even_sizes_each_level(level, mode):
    shape, x = (1, 4, 16, 16), _x((1, 4, 16, 16), seed=level)
    (jl, jh) = jax.jit(lambda v: jw.dwt2d(v, "db4", level, mode))(jnp.asarray(x))
    tl, th = tw.dwt2d(torch.from_numpy(x), "db4", level, mode)
    _close(tl, jl)
    for a, b in zip(th, jh):
        _close(a, b)
    _close(tw.idwt2d(tl, th, "db4", mode, out_hw=shape[-2:]), x)
    # without out_hw: the synthesis length the JAX package picks
    jrec = jax.jit(lambda a, b: jw.idwt2d(a, b, "db4", mode))(jl, jh)
    _close(tw.idwt2d(tl, th, "db4", mode), jrec)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wave", WAVES)
def test_dwt1d_and_inverse_match_jax(wave, mode):
    n, x = 37, _x((2, 3, 37), seed=4)
    run = jax.jit(lambda v: (jw.dwt1d(v, wave, 3, mode),
                             jw.idwt1d(*jw.dwt1d(v, wave, 3, mode), wave, mode, out_len=n)))
    (jl, jh), jrec = run(jnp.asarray(x))
    tl, th = tw.dwt1d(torch.from_numpy(x), wave, 3, mode)
    _close(tl, jl)
    for a, b in zip(th, jh):
        _close(a, b)
    rec = tw.idwt1d(tl, th, wave, mode, out_len=n)
    _close(rec, jrec)
    _close(rec, x)


def test_filter_banks_are_the_jax_packages():
    assert tcoeffs.wavelist() == jcoeffs.wavelist()
    for name in tcoeffs.wavelist():
        a, b = tcoeffs.get_wavelet(name), jcoeffs.get_wavelet(name)
        for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_float64_transform_is_exact_to_float64():
    x = np.random.default_rng(9).standard_normal((1, 2, 20, 12))
    tl, th = tw.dwt2d(torch.from_numpy(x), "db4", 3, "periodization")
    assert tl.dtype == torch.float64
    rec = tw.idwt2d(tl, th, "db4", "periodization", out_hw=(20, 12))
    assert float((rec - torch.from_numpy(x)).abs().max()) <= 1e-12


BENCH_SPEC = [7.0, [6.0, 6.0, 7.0], "fill"]  # bench.py:475


@pytest.mark.parametrize("spec", [BENCH_SPEC, 6.0, [0.5, 2.0], [1.5, "fill"],
                                  [[1.0, 2.0], [3.0]], [2.0, 3.0, 4.0, 5.0]])
@pytest.mark.parametrize("one_d", [False, True])
def test_expand_yh_scales_and_wavelet_scaling_match_jax(spec, one_d):
    shape = (1, 4, 32) if one_d else (1, 4, 32, 32)
    x = _x(shape, seed=2)
    fwd_j = jw.dwt1d if one_d else jw.dwt2d
    fwd_t = tw.dwt1d if one_d else tw.dwt2d
    jl, jh = fwd_j(jnp.asarray(x), "db4", 3, "periodization")
    tl, th = fwd_t(torch.from_numpy(x), "db4", 3, "periodization")
    assert tw.expand_yh_scales(th, yh_scales=spec) == jw.expand_yh_scales(jh, yh_scales=spec)
    jyl, jyh = jw.wavelet_scaling(jl, jh, 1.25, spec)
    tyl, tyh = tw.wavelet_scaling(tl, th, 1.25, spec)
    _close(tyl, jyl)
    assert len(tyh) == len(jyh)
    for a, b in zip(tyh, jyh):
        _close(a, b)


def test_expand_yh_scales_refuses_what_jax_refuses():
    th = tw.dwt2d(torch.zeros(1, 1, 16, 16), "haar", 3, "periodization")[1]
    for bad in (["fill", 1.0], [1.0, "fill", "fill"], ["fill"]):
        with pytest.raises(ValueError):
            tw.expand_yh_scales(th, yh_scales=bad)


@pytest.mark.parametrize("kw", [dict(), dict(use_1d_dwt=True), dict(inv_mode="zero"),
                                dict(mode="periodization", inv_wave="haar")])
@pytest.mark.parametrize("two_step", [False, True])
def test_wavelet_facade_matches_jax(kw, two_step):
    shape = (1, 3, 40) if kw.get("use_1d_dwt") else (1, 3, 21, 18)
    x = _x(shape, seed=6)
    jwv, twv = jw.Wavelet(level=2, **kw), tw.Wavelet(level=2, **kw)
    jl, jh = jwv.forward(jnp.asarray(x))
    tl, th = twv.forward(torch.from_numpy(x))
    _close(tl, jl)
    jy = jwv.inverse(jl, jh, two_step_inverse=two_step)
    ty = twv.inverse(tl, th, two_step_inverse=two_step)
    _close(ty, jy)
    blend = tw.wavelet_blend((tl, th), (tl * 2, tuple(h * 3 for h in th)), yl_factor=0.25,
                             blend_function=lambda a, b, t: a + (b - a) * t)
    _close(blend[0], np.asarray(jl) * 1.25)
    _close(blend[1][0], np.asarray(jh[0]) * 1.5)


def test_dtcwt_is_not_ported_yet():
    """Once a pin of the refusal of ``use_dtcwt``; the dual tree is ported
    now, so this holds its default banks against the JAX package's
    (tests/test_torch_dtcwt.py holds every bank)."""
    assert tw.Wavelet.modelist() == jw.Wavelet.modelist()
    x = _x((1, 2, 16, 16), seed=7)
    jwv, twv = jw.Wavelet(use_dtcwt=True, level=2), tw.Wavelet(use_dtcwt=True, level=2)
    jl, jh = jwv.forward(jnp.asarray(x))
    tl, th = twv.forward(torch.from_numpy(x))
    _close(tl, jl)
    for a, b in zip(th, jh):
        assert a.is_complex() and a.shape[2] == 6
        _close(torch.view_as_real(a), np.stack([np.real(b), np.imag(b)], -1))
    _close(twv.inverse(tl, th), jwv.inverse(jl, jh))
    with pytest.raises(ValueError):
        tw.dwt2d(torch.zeros(1, 1, 8, 8), "db4", 1, "mirror")
