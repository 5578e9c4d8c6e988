"""Every sampler of the port's registry on a dp-sharded latent, and the
guided paths of the JAX package's dryrun (``__graft_entry__.py:259-366``).

One gloo world of 4 CPU ranks (``tests/_parallel_worlds.parallel_samplers_world``)
steps a 4×4×16×16 latent split on dp (one row a rank) through all 31 names
with a float32 stub denoiser. Each rank's rows, put together, are held
against JAX's unsharded trajectory on the same injected numpy noise
(``noise_sampler=``; restart's jumps from one numpy table on both sides), as
``test_torch_parallel.py``'s ``test_dp_sampler_matches_jax``. The SDE names
are also run on their default Brownian noise and held against the port's own
unsharded run, and the guided paths (wavelet CFG + FreeU + a latent-op CFG
guiding sonar_euler, dpmpp_2s_ancestral with pyramid noise, uni_pc, the flow
DiT) against the port's unsharded run of the same pipeline.

Tolerances: against JAX 1e-5 relative to max(1, |JAX|) (float32 steps in
another order, as in ``test_torch_parallel.py``); against the port's own
unsharded run 1e-5 relative as well (a normalized draw's statistics are
float64 sums over the ranks on the shard, float32 over the whole latent
unsharded; dpm_adaptive's error norm likewise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.api.functions as japi_f
import sonar_tpu.samplers.restart as JR
import sonar_tpu_torch.api.functions as tapi_f
import sonar_tpu_torch.parallel as tp
from _parallel_worlds import (SAMPLER_SHAPE, SDE_NAMES, _stub, guided_cases,
                              parallel_samplers_world, restart_table, sampler_sigmas,
                              takes_noise_sampler)

RANKS = 4
REL = 1e-5
NAMES = sorted(tapi_f.SAMPLERS)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "x0": (rng.standard_normal(SAMPLER_SHAPE) * 14.6).astype(np.float32),
        "target": (np.arange(np.prod(SAMPLER_SHAPE), dtype=np.float32)
                   .reshape(SAMPLER_SHAPE) / 1e3),
        "noises": [rng.standard_normal(SAMPLER_SHAPE).astype(np.float32) for _ in range(40)],
    }


@pytest.fixture(scope="module")
def world(data):
    return tp.run_world(parallel_samplers_world, RANKS, backend="gloo", device_type="cpu",
                        args=(data,))


def _gather(world, key):
    return np.concatenate([r[key][0] if isinstance(r[key], tuple) else r[key]
                           for r in world])


class _FakeJax:
    """``jax`` for sonar_tpu.samplers.restart: random.normal hands out
    :func:`restart_table`'s draws in call order; everything else is jax's."""

    def __init__(self):
        outer = self
        self.calls = 0

        class _Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def normal(self, key, shape=(), dtype=jnp.float32):
                outer.calls += 1
                return jnp.asarray(restart_table(outer.calls - 1, shape), dtype)

        self.random = _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_stub(target):
    t = jnp.asarray(target)
    return lambda x, s, **_: ((x.astype(jnp.float32) * 0.9 + t)
                              / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05))


@pytest.mark.parametrize("name", NAMES)
def test_registry_name_on_dp_matches_jax(world, data, name, monkeypatch):
    """dp=4: each rank steps its row on its rows of the injected noise; the
    rows together are JAX's unsharded trajectory, and the result is a
    DTensor laid out as the input."""
    fn = japi_f.SAMPLERS[name]
    kw = {}
    if takes_noise_sampler(tapi_f.SAMPLERS[name]):
        stacked = jnp.asarray(np.stack(data["noises"]))
        kw["noise_sampler"] = lambda i, s, sn: stacked[i]
    fake = _FakeJax()
    monkeypatch.setattr(JR, "jax", fake)
    ref = fn(_jax_stub(data["target"]), jnp.asarray(data["x0"]),
             jnp.asarray(sampler_sigmas()), seed=3, **kw)
    if name == "restart":
        assert all(r["restart_jumps"] == fake.calls > 0 for r in world)
    assert all(r[name][1] == "(Shard(dim=0),)" for r in world)
    _close_rel(_gather(world, name), np.asarray(ref))


def test_dpm_adaptive_ranks_take_the_same_steps(world):
    """dpm_adaptive accepts on the whole latent's error norm: every rank
    makes the same model calls, so no rank waits alone in a collective."""
    calls = [r["dpm_adaptive"][2] for r in world]
    assert len(set(calls)) == 1 and calls[0] > 6, calls


@pytest.mark.parametrize("name", SDE_NAMES)
def test_sde_names_on_brownian_noise(world, data, name):
    """The SDE names on their default Brownian noise: each rank's rows of the
    whole latent's Brownian path, against the port's unsharded run."""
    fn = tapi_f.SAMPLERS[name]
    ref = fn(_stub(data["target"]), torch.from_numpy(data["x0"]),
             torch.from_numpy(sampler_sigmas()), seed=3)
    _close_rel(_gather(world, "brownian " + name), ref.numpy())


@pytest.mark.parametrize("case", ["wcfg_freeu_latent_op", "dpmpp_2s_ancestral_pyramid",
                                  "uni_pc", "flow_dit"])
def test_guided_paths_on_dp_match_unsharded(world, case):
    """The JAX package's dryrun paths on a dp-sharded latent: wavelet CFG
    (db4, level 2, per-band scales) + FreeU-Extreme (backbone, stage 1,
    hidden mean, a power filter) + a latent-op CFG guiding sonar_euler;
    dpmpp_2s_ancestral with pyramid noise; uni_pc; the flow DiT with
    ``Flow(shift=3.0)``. Each against the same pipeline unsharded."""
    pipe, x0, sig = guided_cases()[case]
    with torch.no_grad():
        ref = pipe(x0, torch.from_numpy(sig))
    assert all(r["guided " + case][1] == "(Shard(dim=0),)" for r in world)
    _close_rel(_gather(world, "guided " + case), ref.numpy())
