"""The port's mesh layer and dp-sharded sampling against the JAX package's
unsharded functions.

One gloo world of 4 CPU ranks (``parallel.run_world``) runs every case of
this file once (``tests/_parallel_worlds.parallel_world``); each test reads
its case from the ranks' results. The JAX side is always the unsharded
function on the whole latent: the JAX package's own tests hold its sharded
paths equal to its unsharded ones.

Tolerances: trajectories 1e-5 relative to max(1, |JAX|) (float32 steps in
another order); ``scale_noise`` 1e-6 relative to max(1, |JAX|) (the global
sums in float64 on the port's side); the port's Philox draws bit for bit
against its own unsharded draw.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sonar_tpu.core.normalize as jn
import sonar_tpu.parallel as jp
import sonar_tpu.samplers.sonar as js
import sonar_tpu_torch.parallel as tp
from _parallel_worlds import _sigmas, parallel_world
from sonar_tpu.api import SonarPipeline as JPipeline
from sonar_tpu_torch.kernels.hwrng import philox_rand, philox_randn
from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler

RANKS = 4
SHAPE = (4, 4, 16, 16)
REL = 1e-5


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _deadband_input(rng):
    """Each rank's block has mean 0.05 and std 1.06 exactly: past the global
    N's threshold 2.5/√4096 = 0.039 on both statistics, inside each block's
    own 2.5/√1024 = 0.078."""
    blocks = []
    for _ in range(RANKS):
        z = rng.standard_normal((1,) + SHAPE[1:])
        z = (z - z.mean()) / z.std(ddof=1)
        blocks.append(z * 1.06 + 0.05)
    return np.concatenate(blocks).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = len(_sigmas()) - 1
    return {
        "x0": (rng.standard_normal(SHAPE) * 14.6).astype(np.float32),
        "target": (np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE) / 1e3),
        "noises": [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)],
        "stats": (rng.standard_normal(SHAPE) * 3.0 + 1.0).astype(np.float32),
        "deadband": _deadband_input(rng),
    }


@pytest.fixture(scope="module")
def world(data):
    return tp.run_world(parallel_world, RANKS, backend="gloo", device_type="cpu",
                        args=(data,))


def _gather(world, key):
    return np.concatenate([r[key] for r in world])


@pytest.mark.parametrize("names", [("dp", "tp"), ("dp",), ("dp", "tp", "sp")],
                         ids=["dp-tp", "dp", "dp-tp-sp"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_mesh_factoring(world, n, names):
    """make_mesh factors the first n ranks as the JAX package factors its
    first n devices."""
    want = tuple(jp.make_mesh(n, axis_names=names).shape.values())
    assert all(r["factoring"][(n, names)] == want for r in world)


@pytest.mark.parametrize("ndim,sp", [(4, None), (5, None), (5, "sp"), (3, "sp")])
def test_latent_spec(ndim, sp):
    assert tp.latent_spec(ndim, sp=sp) == tuple(jp.latent_spec(ndim, sp=sp))


def _jax_stub(target):
    t = jnp.asarray(target)
    return lambda x, s, **_: (x * 0.9 + t) / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05)


@pytest.mark.parametrize("sampler", ["ancestral", "euler"])
def test_dp_sampler_matches_jax(world, data, sampler):
    """dp=4: each rank steps its row of the latent on its rows of the
    injected noise; the rows together are JAX's unsharded trajectory."""
    stacked = jnp.asarray(np.stack(data["noises"]))
    model = _jax_stub(data["target"])
    x0, sig = jnp.asarray(data["x0"]), jnp.asarray(_sigmas())
    if sampler == "ancestral":
        ref = js.sample_sonar_euler_ancestral(model, x0, sig,
                                              noise_sampler=lambda i, s, sn: stacked[i])
    else:
        ref = js.sample_sonar_euler(model, x0, sig)
    _close_rel(_gather(world, sampler), np.asarray(ref))


def test_output_keeps_the_placements(world):
    """The sampler hands back a DTensor laid out as its input; a latent split
    on the wrong axis keeps that wrong layout, so the equality discriminates."""
    for r in world:
        got, given, shape = r["placements"]
        assert got == given == r["latent_placements"] == "(Shard(dim=0),)"
        assert shape == SHAPE
        assert r["wrong_placements"] == "(Shard(dim=1),)" != given


@pytest.mark.parametrize("kind", ["rand", "randn", "gaussian", "pyramid"])
@pytest.mark.parametrize("layout", ["dp", "dp ragged", "sp"])
def test_sharded_draws_are_slices(world, layout, kind):
    """The port's Philox stream sharded on dp (also where a rank's block
    starts inside a Philox group of four) and on sp: each rank draws its
    slice of the unsharded draw, bit for bit; gaussian and pyramid noise
    through the noise sampler too (pyramid's B4 base pair and small levels
    at their global planes)."""
    shape = {"dp": SHAPE, "dp ragged": (4, 3, 5, 7), "sp": (1, 4, 8, 16, 16)}[layout]
    if kind == "rand":
        full = philox_rand(11, shape, device="cpu")
    elif kind == "randn":
        full = philox_randn(11, shape, device="cpu")
    else:
        fn, st = make_noise_sampler(get_noise_item(kind), shape, device="cpu", seed=4)
        full = fn(st, 5.0, 1.0)[0]
    if kind in ("gaussian", "pyramid"):  # normalized over the whole draw
        assert abs(float(full.mean())) < 0.1
    for r in world:
        offset, local = r["draws"][layout]["box"]
        box = tuple(slice(o, o + n) for o, n in zip(offset, local))
        if kind in ("gaussian", "pyramid"):  # B2 split sums in float64, B2 in float32
            _close_rel(r["draws"][layout][kind], full[box].numpy(), 1e-6)
        else:
            np.testing.assert_array_equal(r["draws"][layout][kind], full[box].numpy())


def test_unshardable_noise_refused(world):
    """An item that does not say SHARDABLE (a user's own) cannot draw a
    shard's slice: it raises, naming itself."""
    for r in world:
        kind, msg = r["refused"]
        assert kind == "NotImplementedError" and "UserNoise" in msg


@pytest.mark.parametrize("key", ["stats", "deadband"])
def test_scale_noise_global_stats_under_dp(world, data, key):
    """scale_noise's global mode on dp shards: the statistics and the
    dead-band are the whole latent's. On ``deadband`` the branches flip on the
    global N: each block alone (its own N) passes through untouched."""
    ref = np.asarray(jn.scale_noise(jnp.asarray(data[key]), 1.5))
    _close_rel(_gather(world, key), ref, 1e-6)
    if key == "deadband":
        local = _gather(world, key + "_local_n")
        np.testing.assert_array_equal(local, data[key] * np.float32(1.5))
        assert np.abs(ref - local).max() > 0.05


def test_batched_cfg_under_dp_matches_pair(world, data):
    """SonarPipeline with ``model_batched`` on a dp-sharded latent (the
    doubled batch stays on each rank) against JAX's unsharded
    (model, model_uncond) pair, one injected noise stream."""

    def cond(x, s, **_):
        return x / (1.0 + jnp.reshape(jnp.asarray(s, x.dtype), (-1, 1, 1, 1)))

    def uncond(x, s, **_):
        return (x * 0.97) / (1.0 + jnp.reshape(jnp.asarray(s, x.dtype), (-1, 1, 1, 1)))

    stacked = jnp.asarray(np.stack(data["noises"]))
    pipe = JPipeline(model=cond, model_uncond=uncond, cfg_scale=6.0, seed=5)
    ref = pipe(jnp.asarray(data["x0"]), jnp.asarray(_sigmas()),
               noise_sampler=lambda i, s, sn: stacked[i])
    assert all(r["cfg"][1] == "(Shard(dim=0),)" for r in world)
    _close_rel(np.concatenate([r["cfg"][0] for r in world]), np.asarray(ref))

