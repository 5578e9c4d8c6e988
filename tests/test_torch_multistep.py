"""The coefficient-table multistep samplers (deis, lms, ipndm, ipndm_v,
uni_pc, uni_pc_bh2) and DPM-Solver fast/adaptive of the port against the JAX
package on the CPU.

The solver tables are host numpy in both packages and are held equal bit for
bit. Trajectories: a float32 stub denoiser (and a narrow UNet for uni_pc),
noise injected as one numpy stream ``noise_sampler(step, sigma, sigma_next)``
where a sampler draws, 1e-4 relative to the trajectory's largest magnitude
(host float32 scalars against XLA's, chains of steps rounding in another
order). ``dpm_adaptive`` is also held to the JAX package's sequence of
attempts: the sigmas of its model calls in order (so the count of attempts
and of accepted steps) and the attempts at which it draws (``eta > 0``: on
accepted attempts only, indexed by the attempt counter); the sigmas
themselves agree within 1e-4 relative, as the step sizes follow the error
estimates. The JAX side records both at run time with
``jax.debug.callback``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.models.unet as ju
import sonar_tpu.samplers.dpm_solver as JD
import sonar_tpu.samplers.multistep as JM
import sonar_tpu_torch.api as tapi
import sonar_tpu_torch.models.unet as tu
import sonar_tpu_torch.samplers.dpm_solver as TD
import sonar_tpu_torch.samplers.multistep as TM
from sonar_tpu_torch.noise import get_noise_item

REL = 1e-4
SHAPE = (1, 4, 8, 8)
STEPS = 8
UNET_KW = dict(model_channels=16, channel_mult=(1, 2), attention_levels=(1,),
               num_heads=2, norm_groups=4)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _sigmas(steps=STEPS, tail=True):
    """bench.py's Karras-style schedule 14.6 → 0.03, with or without a final 0."""
    ramp = np.linspace(0, 1, steps)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return (np.concatenate([s, [0.0]]) if tail else s).astype(np.float32)


def _stub(lib, record=None):
    """A float32 denoiser; ``record`` collects the sigma of each call."""
    target = np.arange(int(np.prod(SHAPE)), dtype=np.float32).reshape(SHAPE) / 100.0
    if lib == "jax":
        t = jnp.asarray(target)

        def jm(x, s, **_):
            if record is not None:
                jax.debug.callback(lambda v: record.append(float(np.asarray(v)[0])), s,
                                   ordered=True)
            return (x.astype(jnp.float32) * 0.9 + t) / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05)
        return jm
    t = torch.from_numpy(target)

    def tm(x, s, **_):
        if record is not None:
            record.append(float(s[0]))
        return (x.float() * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)
    return tm


def _streams(n, jrec=None, trec=None, seed=5):
    rng = np.random.default_rng(seed)
    noises = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]
    stacked = jnp.asarray(np.stack(noises))

    def jns(i, s, sn):
        if jrec is not None:
            jax.debug.callback(lambda v: jrec.append(int(v)), i, ordered=True)
        return stacked[i]

    def tns(i, s, sn):
        if trec is not None:
            trec.append(i)
        return torch.from_numpy(noises[i])

    return jns, tns


def _x0(sig):
    x0 = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * sig[0]
    return jnp.asarray(x0), torch.from_numpy(x0)


def _unets():
    jcfg = ju.UNetConfig(**UNET_KW)
    params = jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), jcfg)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**UNET_KW))
    model.load_state_dict(tu.unet_params_from_jax(jax.tree.map(np.asarray, params)),
                          assign=True)
    return ju.make_denoiser(params, jcfg), tu.make_denoiser(model.eval())


# ---------------------------------------------------------------------------
# host tables, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,tail", [(2, True), (3, True), (8, True), (8, False), (20, True)])
def test_tables_equal_the_jax_packages(steps, tail):
    sig = _sigmas(steps, tail).astype(np.float64)
    for mode in ("deis", "lagrange", "fixed"):
        for order in (1, 2, 3, 4):
            np.testing.assert_array_equal(TM._d_coeff_table(sig, order, mode),
                                          JM._d_coeff_table(sig, order, mode))
    for variant in ("bh1", "bh2"):
        for got, want in zip(TM._unipc_tables(sig, variant), JM._unipc_tables(sig, variant)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TM._concrete_sigmas(torch.from_numpy(_sigmas(steps, tail))),
                                  JM._concrete_sigmas(_sigmas(steps, tail), "x"))
    grid = TD._sigma_grid(torch.from_numpy(_sigmas(steps, tail)), "dpm_fast")
    assert grid == JD._sigma_grid(_sigmas(steps, tail), "dpm_fast")
    for eta in (0.0, 0.5):
        assert TD._fast_segments(*grid, eta) == JD._fast_segments(*grid, eta)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

D_CASES = [("deis", 1), ("deis", 2), ("deis", 3), ("lms", 2), ("lms", 4), ("ipndm", 3),
           ("ipndm", 4), ("ipndm_v", 4)]


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("name,max_order", D_CASES, ids=[f"{n}-{o}" for n, o in D_CASES])
def test_d_multistep_matches_jax(name, max_order, tail):
    sig = _sigmas(tail=tail)
    jx, tx = _x0(sig)
    ref = JM.MULTISTEP_SAMPLERS[name](_stub("jax"), jx, jnp.asarray(sig), max_order=max_order)
    out = TM.MULTISTEP_SAMPLERS[name](_stub("torch"), tx, torch.from_numpy(sig),
                                      max_order=max_order)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("steps,tail", [(2, True), (3, True), (4, True), (8, True), (8, False)])
@pytest.mark.parametrize("name", ["uni_pc", "uni_pc_bh2"])
def test_uni_pc_matches_jax(name, steps, tail):
    sig = _sigmas(steps, tail)
    jx, tx = _x0(sig)
    jcalls, tcalls = [], []
    ref = JM.MULTISTEP_SAMPLERS[name](_stub("jax", jcalls), jx, jnp.asarray(sig))
    out = TM.MULTISTEP_SAMPLERS[name](_stub("torch", tcalls), tx, torch.from_numpy(sig))
    _close_rel(out.numpy(), ref)
    jax.effects_barrier()
    assert len(tcalls) == len(jcalls) == len(sig)  # sigma_0, then one a step
    _close_rel(tcalls, jcalls, rel=1e-6)


@pytest.mark.parametrize("name", ["uni_pc", "lms"])
def test_unet_slice_matches_jax(name):
    """The slice as a whole: a narrow UNet through make_denoiser, four steps."""
    sig = _sigmas(4)
    jx, tx = _x0(sig)
    jm, tm = _unets()
    ref = JM.MULTISTEP_SAMPLERS[name](jm, jx, jnp.asarray(sig))
    out = TM.MULTISTEP_SAMPLERS[name](tm, tx, torch.from_numpy(sig))
    _close_rel(out.numpy(), ref)


@pytest.mark.parametrize("name", ["lms", "uni_pc", "deis"])
def test_resume_is_bitwise(name):
    """The history buffer rides the carry: stop/resume continues bit for bit."""
    sig = torch.from_numpy(_sigmas())
    x0 = _x0(_sigmas())[1]
    fn, model = TM.MULTISTEP_SAMPLERS[name], _stub("torch")
    full = fn(model, x0, sig)
    _x, carry = fn(model, x0, sig, stop_step=3, return_state=True)
    assert torch.equal(fn(model, x0, sig, resume_from=carry, start_step=3), full)


def test_bf16_latent_runs_in_float32_steps():
    """A bfloat16 latent: the history is kept in bfloat16 as the JAX carry
    keeps it, each step computes in float32."""
    sig = _sigmas()
    jx, tx = _x0(sig)
    for name in ("lms", "uni_pc"):
        ref = JM.MULTISTEP_SAMPLERS[name](_stub("jax"), jx.astype(jnp.bfloat16), jnp.asarray(sig))
        out = TM.MULTISTEP_SAMPLERS[name](_stub("torch"), tx.bfloat16(), torch.from_numpy(sig))
        assert out.dtype == torch.bfloat16
        _close_rel(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rel=2 * 2.0**-7)


@pytest.mark.parametrize("steps", [6, 7, 8], ids=["nfe%3=0", "nfe%3=1", "nfe%3=2"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_dpm_fast_matches_jax(steps, eta):
    sig = _sigmas(steps - 1)  # nfe = steps
    jx, tx = _x0(sig)
    jcalls, tcalls, trec = [], [], []
    jns, tns = _streams(len(sig), trec=trec)
    ref = JD.sample_dpm_fast(_stub("jax", jcalls), jx, jnp.asarray(sig), eta=eta,
                             noise_sampler=jns)
    out = TD.sample_dpm_fast(_stub("torch", tcalls), tx, torch.from_numpy(sig), eta=eta,
                             noise_sampler=tns)
    _close_rel(out.numpy(), ref)
    jax.effects_barrier()
    assert len(tcalls) == len(sig) - 1  # nfe model calls
    n_segs = len(TD._fast_segments(*TD._sigma_grid(torch.from_numpy(sig), "x"), eta))
    assert trec == (list(range(n_segs)) if eta else [])


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_dpm_adaptive_matches_jax(order, eta):
    """The same attempts in the same order (the model-call sigmas), so the
    same accepted steps; with eta > 0 draws on accepted attempts only,
    indexed by the attempt counter."""
    sig = _sigmas()
    jx, tx = _x0(sig)
    jcalls, tcalls, jrec, trec = [], [], [], []
    jns, tns = _streams(1000, jrec=jrec, trec=trec)
    kw = dict(order=order, eta=eta, h_init=2.0, rtol=0.005, atol=0.0005)
    ref = JD.sample_dpm_adaptive(_stub("jax", jcalls), jx, jnp.asarray(sig), noise_sampler=jns,
                                 **kw)
    out = TD.sample_dpm_adaptive(_stub("torch", tcalls), tx, torch.from_numpy(sig),
                                 noise_sampler=tns, **kw)
    jax.effects_barrier()
    assert len(tcalls) == len(jcalls) and len(tcalls) % order == 0
    # the step sizes follow the error estimates, which follow the latents:
    # the sigmas agree to the trajectories' tolerance, the accepts exactly
    _close_rel(tcalls, jcalls)
    firsts = tcalls[::order]
    attempts, accepted = len(firsts), len(set(firsts))
    assert accepted == len(set(jcalls[::order]))
    assert accepted < attempts  # the controller rejected some attempts
    if eta:
        assert trec == jrec and len(trec) == accepted
        assert trec[-1] == attempts - 1 and trec != list(range(accepted))
    else:
        assert trec == jrec == []
    _close_rel(out.numpy(), ref)


def test_dpm_adaptive_bounds_its_attempts():
    sig = torch.from_numpy(_sigmas())
    calls = []
    out = TD.sample_dpm_adaptive(_stub("torch", calls), _x0(_sigmas())[1], sig, max_steps=4)
    assert len(calls) == 4 * 3 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("fn", [TD.sample_dpm_fast, TD.sample_dpm_adaptive])
def test_callback_is_refused_as_in_jax(fn):
    sig = torch.from_numpy(_sigmas())
    with pytest.raises(NotImplementedError, match="callback is not supported"):
        fn(_stub("torch"), _x0(_sigmas())[1], sig, callback=lambda d: None)


@pytest.mark.parametrize("name", ["uni_pc", "deis", "dpm_fast", "dpm_adaptive"])
def test_pipeline_runs_the_host_table_samplers(name):
    """SonarPipeline hands them its host schedule; the deterministic ones
    ignore a configured noise item, as in the JAX package."""
    sig = torch.from_numpy(_sigmas())
    pipe = tapi.SonarPipeline(model=_stub("torch"), sampler=name,
                              noise=get_noise_item("pyramid"), seed=3)
    out = pipe(_x0(_sigmas())[1], sig)
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())
    assert pipe.sampler._needs_host_sigmas
