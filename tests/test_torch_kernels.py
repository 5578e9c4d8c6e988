"""Kernels B1 (fused momentum step) and B2 (fused scale_noise).

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the JAX package's references and against its Pallas kernels
run in interpret mode, on the same numpy inputs. Tolerance: 1e-6 absolute
for this elementwise code (scaled by the output's magnitude where it exceeds
1); B2 sums in another order than XLA, which moves the mean and std in the
last bits only.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sonar_tpu.kernels.fused as JF
from sonar_tpu.core.normalize import scale_noise as j_scale_noise
import sonar_tpu_torch.kernels.fused as TF

ATOL = 1e-6
GATES = [(h, i, w) for h in (0.0, 1.0) for i in (0.0, 1.0) for w in (0.0, 1.0)]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True})
    )


def _tensors(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _scal_kw(has, in_window, hist_window, noise_scale=0.5):
    return dict(sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75, hd_scale=1.05,
                md_scale=1.0, has=has, noise_scale=noise_scale, in_window=in_window,
                hist_window=hist_window)


def _close(a, b, atol=ATOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= atol * scale


@pytest.mark.parametrize("gates", GATES + [(1.0, 1.0, 1.0, 0.0)])
def test_momentum_plain_matches_jax_reference(gates):
    x, den, hd, noise = _tensors((1, 4, 16, 16))
    kw = _scal_kw(*gates)
    ref = JF.fused_momentum_step_reference(
        *(jnp.asarray(a) for a in (x, den, hd, noise)), JF.pack_momentum_scalars(**kw))
    out = TF.fused_momentum_step(
        *(torch.from_numpy(a) for a in (x, den, hd, noise)), TF.pack_momentum_scalars(**kw))
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


@pytest.mark.parametrize("gates", [(1.0, 1.0, 1.0), (0.0, 1.0, 1.0), (1.0, 0.0, 1.0),
                                   (1.0, 1.0, 0.0)])
def test_momentum_plain_matches_pallas_interpret(gates, interpret_pallas):
    x, den, hd, noise = _tensors((1, 4, 12, 11), seed=1)  # ragged: padded tail
    kw = _scal_kw(*gates)
    ref = JF.fused_momentum_step(*(jnp.asarray(a) for a in (x, den, hd, noise)),
                                 JF.pack_momentum_scalars(**kw), force_pallas=True)
    out = TF.fused_momentum_step(
        *(torch.from_numpy(a) for a in (x, den, hd, noise)), TF.pack_momentum_scalars(**kw))
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


def test_pack_momentum_scalars_rows_and_table():
    row = TF.pack_momentum_scalars(**_scal_kw(True, False, True))
    assert row.dtype == torch.float32 and row.shape == (10,)
    np.testing.assert_array_equal(
        row.numpy(), np.asarray(JF.pack_momentum_scalars(**_scal_kw(True, False, True))))
    table = TF.pack_momentum_scalars(
        **{**_scal_kw(0.0, 1.0, 1.0), "sigma": torch.tensor([3.0, 2.0, 1.0])})
    assert table.shape == (3, 10)
    np.testing.assert_array_equal(table[:, 0].numpy(), [3.0, 2.0, 1.0])
    np.testing.assert_array_equal(table[1, 1:].numpy(), row.new_tensor(
        [-2.0, 0.95, 0.75, 1.05, 1.0, 0.0, 0.5, 1.0, 1.0]).numpy())


def _scale_noise_inputs():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1, 4, 16, 16))
    std_normal = ((base - base.mean()) / base.std(ddof=1)).astype(np.float32)
    return {
        "standard": (std_normal, 1.0),
        "shifted_mean": ((base + 0.5).astype(np.float32), 1.0),
        "scaled_std": ((base * 3.0).astype(np.float32), 1.0),
        "shift_and_scale": ((base * 3.0 + 1.0).astype(np.float32), 1.0),
        "zeros": (np.zeros((1, 4, 16, 16), np.float32), 1.0),
        "constant": (np.full((1, 4, 16, 16), 2.5, np.float32), 1.0),
        "factor": ((base * 2.0 - 0.3).astype(np.float32), 1.7),
        "ragged": (rng.standard_normal((1, 3, 7, 5)).astype(np.float32) * 4, 1.0),
    }


@pytest.mark.parametrize("case", sorted(_scale_noise_inputs()))
def test_scale_noise_plain_matches_jax(case):
    x, factor = _scale_noise_inputs()[case]
    ref = j_scale_noise(jnp.asarray(x), factor, normalized=True)
    out = TF.fused_scale_noise(torch.from_numpy(x), factor)
    _close(out.numpy(), ref)
    if case in ("standard", "zeros"):  # dead-band / zero-std: passes through as is
        np.testing.assert_array_equal(out.numpy(), x)


@pytest.mark.parametrize("case", ["shift_and_scale", "factor", "ragged"])
def test_scale_noise_plain_matches_pallas_interpret(case, interpret_pallas):
    x, factor = _scale_noise_inputs()[case]
    ref = JF.fused_scale_noise(jnp.asarray(x), factor, force_pallas=True)
    out = TF.fused_scale_noise(torch.from_numpy(x), factor)
    _close(out.numpy(), ref)


# one size for each of the CUDA kernel's launches (float32): one block, one
# cluster, one cooperative grid. 1e-6 x max(1, |ref|): the JAX kernel sums in
# another order than torch's mean and std, which moves them in the last bits.
TIER_SHAPES = {1: (1, 4, 64, 64), 2: (1, 4, 128, 128), 3: (1, 4, 384, 256)}


@pytest.mark.parametrize("tier", sorted(TIER_SHAPES))
def test_scale_noise_plain_matches_pallas_interpret_at_each_tier(tier, interpret_pallas):
    shape = TIER_SHAPES[tier]
    assert TF.scale_noise_tier(int(np.prod(shape)), 4) == tier
    x = (np.random.default_rng(tier).standard_normal(shape) * 2.0 + 0.25).astype(np.float32)
    ref = JF.fused_scale_noise(jnp.asarray(x), 1.7, force_pallas=True)
    out = TF.fused_scale_noise_reference(torch.from_numpy(x), 1.7)
    _close(out.numpy(), ref)


BLOCK, CLUSTER = TF.SCALE_NOISE_BLOCK_ELEMS, TF.SCALE_NOISE_CLUSTER_ELEMS


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("cap,below,above", [(BLOCK, 1, 2), (CLUSTER, 2, 3)])
def test_scale_noise_tier_changes_at_its_limits(itemsize, cap, below, above):
    n = cap  # in elements, whatever their size
    assert TF.scale_noise_tier(n - 1, itemsize) == below
    assert TF.scale_noise_tier(n, itemsize) == below
    assert TF.scale_noise_tier(n + 1, itemsize) == above


@pytest.mark.parametrize("itemsize", [2, 4])
def test_scale_noise_tier_is_a_function_of_count_and_size_alone(itemsize):
    """The tier fixes the reduction order, so it may read nothing else: no
    device, no tensor, no global that a caller could change."""
    import inspect

    assert list(inspect.signature(TF.scale_noise_tier).parameters) == ["n", "itemsize"]
    code = TF.scale_noise_tier.__code__
    assert set(code.co_names) <= {"SCALE_NOISE_BLOCK_ELEMS", "SCALE_NOISE_CLUSTER_ELEMS", "ValueError"}
    assert TF.scale_noise_tier(1, itemsize) == 1
    assert TF.scale_noise_tier(2**40, itemsize) == 3
    # the sampler's latents: SD-sized in one block, SDXL-sized in one cluster
    assert TF.scale_noise_tier(4 * 64 * 64, itemsize) == 1
    assert TF.scale_noise_tier(4 * 128 * 128, itemsize) == 2
    with pytest.raises(ValueError):
        TF.scale_noise_tier(16, 8)
    tiers = [TF.scale_noise_tier(n, itemsize) for n in range(1, 2**21, 4099)]
    assert tiers == sorted(tiers)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    x, den, hd, noise = (torch.from_numpy(a) for a in _tensors((1, 4, 8, 8)))
    n1, n2 = TF.fused_momentum_step.launches, TF.fused_scale_noise.launches
    TF.fused_momentum_step(x, den, hd, noise, TF.pack_momentum_scalars(**_scal_kw(1, 1, 1)))
    TF.fused_scale_noise(x * 3)
    assert (TF.fused_momentum_step.launches, TF.fused_scale_noise.launches) == (n1, n2)
