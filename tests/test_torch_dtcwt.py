"""The port's dual-tree complex wavelet transform (``wavelets/dtcwt.py``,
``kingsbury.py``) against the JAX package's, on the CPU.

- Filter banks: one numpy module copied, held equal in float64 bit for bit
  (the published pairs, the level-1 assemblies, the q-shift tables and tree
  banks, and the ``native`` designs, BFGS included).
- ``dtcwt2d``/``idtcwt2d`` at 1×2×32×32, levels 1–3, every biort and qshift
  name, and on odd and non-square sizes: 1e-5 relative to max(1, |JAX|)
  (float32 product-sums against XLA's convolutions, complex parts divided
  by √2 in another order), and perfect reconstruction within 1e-5.
- ``Wavelet(use_dtcwt=True)``, one wavelet-CFG call with ``use_dtcwt``
  (``atol=5e-5·scale, rtol=2e-5``, tests/test_torch_wavelet_cfg.py's) and
  ``WaveletFilteredNoise(use_dtcwt=True)`` over stub children (1e-5).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.noise.wavelet as JWN
import sonar_tpu.wavelets as jw
import sonar_tpu.wavelets.dtcwt as JD
import sonar_tpu.wavelets.kingsbury as JK
import sonar_tpu_torch.noise.wavelet as TWN
import sonar_tpu_torch.wavelets as tw
import sonar_tpu_torch.wavelets.dtcwt as TD
import sonar_tpu_torch.wavelets.kingsbury as TK
from _combinator_stubs import run_both, stubs
from test_torch_wavelet_cfg import CONFIG3, _close_wcfg, _wcfg_pair

TOL = 1e-5
BIORTS = ["legall", "near_sym_a", "antonini", "near_sym_b", "near_sym_a_bp",
          "near_sym_b_bp", "native"]
QSHIFTS = ["qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d", "qshift_b_bp",
           "native"]


@pytest.fixture(autouse=True)
def _quiet_substitutions():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


def _close(t, j, tol=TOL):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape, t.dtype, j.dtype)
    err = float(np.abs(t.astype(np.complex128) - j.astype(np.complex128)).max())
    assert err <= tol * max(1.0, float(np.abs(j).max())), err


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bank_arrays(w):
    return [w.name, w.dec_lo, w.dec_hi, w.rec_lo, w.rec_hi]


def _equal_banks(a, b):
    for x, y in zip(_bank_arrays(a), _bank_arrays(b)):
        assert np.array_equal(x, y), (x, y)


@pytest.mark.parametrize("name", ["legall", "near_sym_a", "antonini", "near_sym_b"])
def test_biort_tables_equal_jax(name):
    for t, j in zip(TK.biort_pair(name), JK.biort_pair(name)):
        assert np.array_equal(t, j)
    _equal_banks(TK.biort_level1_bank(name), JK.biort_level1_bank(name))


@pytest.mark.parametrize("name", ["qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
                                  "qshift_b_bp"])
def test_qshift_tables_equal_jax(name):
    (th, te), (jh, je) = TK.qshift_scaling(name), JK.qshift_scaling(name)
    assert np.array_equal(th, jh) and te == je
    for a, b in zip(TK.qshift_tree_banks(name), JK.qshift_tree_banks(name)):
        _equal_banks(a, b)


def test_substituted_banks_warn_as_jax_does():
    for name in ("qshift_a", "qshift_c", "qshift_d"):
        with pytest.warns(UserWarning, match="substituting"):
            TK.qshift_scaling(name)
    assert TK.BIORT_EXACT == JK.BIORT_EXACT and TK.QSHIFT_EXACT == JK.QSHIFT_EXACT


def test_resolved_and_native_banks_equal_jax():
    for b in BIORTS:
        _equal_banks(TD._resolve_level1(b), JD._resolve_level1(b))
    for q in QSHIFTS:
        for a, c in zip(TD._resolve_qshift(q), JD._resolve_qshift(q)):
            _equal_banks(a, c)
    assert np.array_equal(TD.qshift_filter(10), JD.qshift_filter(10))
    _equal_banks(TD.near_sym_bank(), JD.near_sym_bank())
    with pytest.raises(ValueError, match="Unknown biort"):
        TD._resolve_level1("nope")
    with pytest.raises(ValueError, match="Unknown qshift"):
        TD._resolve_qshift("nope")


def _roundtrip(x, level, **kw):
    """(port, jax) of the forward transform and of its inverse."""
    jl, jh = JD.dtcwt2d(jnp.asarray(x), level, **kw)
    tl, th = TD.dtcwt2d(torch.from_numpy(x), level, **kw)
    out_hw = x.shape[-2:]
    return ((tl, th, TD.idtcwt2d(tl, th, out_hw, **kw)),
            (jl, jh, JD.idtcwt2d(jl, jh, out_hw, **kw)))


def _hold(x, level, **kw):
    (tl, th, trec), (jl, jh, jrec) = _roundtrip(x, level, **kw)
    assert len(tl) == 4 and len(th) == len(jh) == level
    for a, b in zip(tl, jl):
        _close(a.numpy(), b)
    for a, b in zip(th, jh):
        assert a.dtype == torch.complex64 and a.shape[2] == 6
        _close(a.numpy(), b)
    _close(trec.numpy(), jrec)
    return trec.numpy()


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("biort", BIORTS)
def test_dtcwt_every_biort_matches_jax(biort, level):
    x = _x((1, 2, 32, 32), seed=level)
    rec = _hold(x, level, biort=biort, qshift="qshift_a")
    _close(rec, x)  # perfect reconstruction


@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("qshift", QSHIFTS)
def test_dtcwt_every_qshift_matches_jax(qshift, level):
    x = _x((1, 2, 32, 32), seed=10 + level)
    rec = _hold(x, level, biort="near_sym_a", qshift=qshift)
    _close(rec, x)


@pytest.mark.parametrize("shape", [(1, 2, 33, 20), (2, 1, 17, 31)])
def test_dtcwt_odd_and_non_square_sizes_match_jax(shape):
    _hold(_x(shape, seed=3), 2, biort="near_sym_b", qshift="qshift_b")


def test_dtcwt_float64_is_complex128():
    x = _x((1, 1, 16, 16)).astype(np.float64)
    tl, th = TD.dtcwt2d(torch.from_numpy(x), 2)
    assert th[0].dtype == torch.complex128 and tl[0].dtype == torch.float64
    _close(TD.idtcwt2d(tl, th).numpy(), x, tol=1e-7)  # the tables have 8 decimals


@pytest.mark.parametrize("two_step", [False, True])
def test_wavelet_use_dtcwt_matches_jax(two_step):
    """The ``use_dtcwt`` test of ``Wavelet``: the four tree lowpasses
    stacked on a leading axis, complex yh with 6 orientations, the scaling
    keeps yh complex, and the inverse."""
    kw = dict(use_dtcwt=True, level=2, biort="antonini", qshift="qshift_b",
              inv_biort="antonini", inv_qshift="qshift_b")
    x = _x((1, 2, 32, 32), seed=6)
    jwv, twv = jw.Wavelet(**kw), tw.Wavelet(**kw)
    jl, jh = jwv.forward(jnp.asarray(x))
    tl, th = twv.forward(torch.from_numpy(x))
    assert tl.shape == (4, 1, 2, 8, 8)
    _close(tl.numpy(), jl)
    for a, b in zip(th, jh):
        _close(a.numpy(), b)
    scales = (0.5, [1.0, 2.0, 3.0], "fill")
    assert tw.expand_yh_scales(th, yh_scales=scales) == jw.expand_yh_scales(jh, yh_scales=scales)
    tl2, th2 = tw.wavelet_scaling(tl, th, 1.5, scales)
    jl2, jh2 = jw.wavelet_scaling(jl, jh, 1.5, scales)
    assert all(h.is_complex() for h in th2)
    for a, b in zip(th2, jh2):
        _close(a.numpy(), b)
    _close(twv.inverse(tl2, th2, two_step_inverse=two_step).numpy(),
           jwv.inverse(jl2, jh2, two_step_inverse=two_step))
    with pytest.raises(ValueError, match="Unknown biort"):
        tw.Wavelet(use_dtcwt=True, biort="db4")


@pytest.mark.parametrize("sigma", [5.0, 12.0])
def test_wcfg_use_dtcwt_matches_jax(sigma):
    """One guided call of the config-3 rule on the DTCWT (level 2): per-band
    and per-orientation scales meet 6 orientations and the 4-tree yl."""
    rules = {**CONFIG3, "level": 2, "use_dtcwt": True, "start_sigma": 9.0, "end_sigma": 1.0}
    got, want = _wcfg_pair(rules, sigma)
    _close_wcfg(got, want)


@pytest.mark.parametrize("high", [False, True])
def test_wavelet_filtered_noise_use_dtcwt_matches_jax(high):
    kw = dict(use_dtcwt=True, level=2, yl_scale=0.7, yh_scales=(1.2, [0.5, 1.5]),
              biort="legall", qshift="qshift_06")
    if high:
        kw.update(yh_blend_high=0.4, preblend_yh_scales_high=0.8)
    (jl, jh), (tl, th) = stubs("low", "high")
    run_both(JWN.WaveletFilteredNoise(noise=jl, noise_high=jh if high else None, **kw),
             TWN.WaveletFilteredNoise(noise=tl, noise_high=th if high else None, **kw),
             (1, 2, 32, 32), n=2)
