"""Kernel B3's stream: Philox4x32-10 with Box-Muller (sonar_tpu_torch.kernels.hwrng).

On the CPU the wrappers run their plain PyTorch version, held here against
the Random123 known-answer vectors and an independent pure-Python Philox
(bitwise), a numpy transcription of the JAX package's Box-Muller
(sonar_tpu/kernels/hwrng.py:57-67; 1e-6 absolute, float32 log/cos/sin
against numpy's), and JAX's own normals by a KS test. The CUDA kernel is
held against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import math

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from sonar_tpu_torch.core.rng import derive_seed, seed_from
from sonar_tpu_torch.kernels import hwrng
from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler

M32 = 0xFFFFFFFF
KAT = [  # (counter, key) -> output, Random123's philox4x32-10 vectors
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _philox_py(c, k):
    """Independent pure-Python Philox4x32-10 (unbounded ints)."""
    c, (k0, k1) = list(c), k
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c


def _box_muller_np(b1, b2):
    """numpy transcription of hwrng.py:57-67 (float32 throughout)."""
    u1 = ((b1 >> 8).astype(np.int32).astype(np.float32) + np.float32(1.0)) * np.float32(
        1.0 / (1 << 24))
    u2 = (b2 >> 8).astype(np.int32).astype(np.float32) * np.float32(1.0 / (1 << 24))
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    theta = np.float32(2.0 * math.pi) * u2
    return r * np.cos(theta), r * np.sin(theta)


def _reference_stream(seed, n, stream=0):
    """Element i of the stream by the definition: pure-Python Philox on the
    counter (i // 4, stream), numpy Box-Muller, lane i % 4."""
    key = (seed & M32, (seed >> 32) & M32)
    words = np.array([_philox_py((g & M32, g >> 32, stream, 0), key)
                      for g in range(-(-n // 4))], dtype=np.uint32)
    a = _box_muller_np(words[:, 0], words[:, 1])
    b = _box_muller_np(words[:, 2], words[:, 3])
    normals = np.stack([a[0], a[1], b[0], b[1]], axis=1).reshape(-1)[:n]
    uniforms = ((words >> 8).astype(np.float64) * 2.0**-24).reshape(-1)[:n]
    return normals, uniforms


def _t(v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answer_vectors(case):
    ctr, key, want = KAT[case]
    got = hwrng.philox4x32_reference(*(_t([c]) for c in ctr), *key)
    assert [int(x) for x in got] == list(want)
    assert _philox_py(ctr, key) == list(want)


def test_plain_philox_matches_pure_python_on_random_words():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64)
    for k0, k1 in rng.integers(0, 2**32, size=(4, 2), dtype=np.uint64):
        got = hwrng.philox4x32_reference(*(_t(c.astype(np.int64)) for c in ctr),
                                         int(k0), int(k1))
        got = np.stack([g.numpy() for g in got], axis=1)
        want = [_philox_py([int(c) for c in ctr[:, j]], (int(k0), int(k1)))
                for j in range(ctr.shape[1])]
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))


def test_box_muller_matches_numpy_transcription():
    bits = np.random.default_rng(1).integers(0, 2**32, size=(2, 4096), dtype=np.uint64)
    bits[:, :4] = [[0, M32, 255, 256], [0, M32, 2**31, 1]]  # u1 = 2^-24 and 1
    got = hwrng.box_muller_pair(*(_t(b.astype(np.int64)) for b in bits))
    want = _box_muller_np(bits[0].astype(np.uint32), bits[1].astype(np.uint32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 4, 8, 8), (1, 3, 7, 5), (13,)])
def test_draw_is_a_pure_function_of_seed_and_counter(shape):
    """The stream definition, element by element: the fault this repairs
    was a draw that depended on the device's own generator."""
    seed = derive_seed(seed_from(7), "noise", 3)
    n = math.prod(shape)
    normals, uniforms = _reference_stream(seed, n)
    got = hwrng.philox_randn(seed, shape, device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(-1), normals, rtol=0, atol=1e-6)
    u = hwrng.philox_rand(seed, shape, device="cpu")
    np.testing.assert_array_equal(u.numpy().reshape(-1).astype(np.float64), uniforms)
    s1, _ = _reference_stream(seed, n, stream=5)
    np.testing.assert_allclose(
        hwrng.philox_randn(seed, shape, device="cpu", stream=5).numpy().reshape(-1),
        s1, rtol=0, atol=1e-6)


def test_noise_sampler_gaussian_draws_the_philox_stream():
    shape = (1, 4, 6, 5)
    fn, state = make_noise_sampler(get_noise_item("gaussian"), shape, seed=11,
                                   normalized=False, device="cpu")
    draws = []
    for _ in range(2):
        noise, state = fn(state, 1.0, 0.5)
        draws.append(noise)
    for counter, got in enumerate(draws):
        want, _ = _reference_stream(derive_seed(seed_from(11), counter), 120)
        np.testing.assert_allclose(got.numpy().reshape(-1), want, rtol=0, atol=1e-6)
    fn, state = make_noise_sampler(get_noise_item("uniform", normalize=False), shape,
                                   seed=11, device="cpu")
    u, _ = fn(state, None, None)
    _, uni = _reference_stream(derive_seed(seed_from(11), 0), 120)
    np.testing.assert_allclose(u.numpy().reshape(-1), (uni.astype(np.float32) - 0.5) * 3.46,
                               rtol=0, atol=1e-6)


def test_moments_determinism_and_prefixes():
    x = hwrng.philox_randn(123, (4, 4, 128, 128), device="cpu").double()
    assert abs(float(x.mean())) < 5e-3 and abs(float(x.std()) - 1.0) < 5e-3
    kurt = float(((x - x.mean()) ** 4).mean() / x.var() ** 2)
    assert abs(kurt - 3.0) < 0.03
    u = hwrng.philox_rand(123, (262144,), device="cpu").double()
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 3e-3 and abs(float(u.var()) - 1 / 12) < 1e-3
    a = hwrng.philox_randn(9, (1, 4, 16, 16), device="cpu")
    assert torch.equal(a, hwrng.philox_randn(9, (1, 4, 16, 16), device="cpu"))
    assert not torch.equal(a, hwrng.philox_randn(10, (1, 4, 16, 16), device="cpu"))
    assert not torch.equal(a, hwrng.philox_randn(9, (1, 4, 16, 16), device="cpu", stream=1))
    assert not torch.equal(a, hwrng.philox_randn(9 + 2**32, (1, 4, 16, 16), device="cpu"))
    # the counter is the element index: a shorter draw is a prefix of a longer
    assert torch.equal(hwrng.philox_randn(9, (1023,), device="cpu"), a.reshape(-1)[:1023])
    bf = hwrng.philox_randn(9, (1, 4, 16, 16), device="cpu", dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, a.bfloat16())


def test_ks_against_jax_normal():
    ours = hwrng.philox_randn(2024, (200_000,), device="cpu").numpy()
    theirs = np.asarray(jax.random.normal(jax.random.key(2024), (200_000,)))
    assert stats.ks_2samp(ours, theirs).pvalue > 1e-3
    assert stats.kstest(ours, "norm").pvalue > 1e-3


def test_cpu_takes_the_plain_version_and_counts_nothing():
    n1, n2 = hwrng.philox_randn.launches, hwrng.philox_rand.launches
    hwrng.philox_randn(1, (4, 4), device="cpu")
    hwrng.philox_rand(1, (4, 4), device=torch.device("cpu"))
    assert (hwrng.philox_randn.launches, hwrng.philox_rand.launches) == (n1, n2)
    assert hwrng.philox_randn(1, (0, 4), device="cpu").shape == (0, 4)
    with pytest.raises(ValueError, match="no kernel"):
        hwrng.philox_randn(1, (4,), device="meta")
