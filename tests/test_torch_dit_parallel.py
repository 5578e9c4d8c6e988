"""The port's DiT under pipeline (pp), tensor (tp), expert (ep) and data
(dp) parallelism against the JAX package's unsharded DiT.

One gloo world of 8 CPU ranks (``parallel.run_world``) runs every case once
(``tests/_parallel_worlds.dit_world``); each case builds its mesh over the
first ranks of the world. The weights are the JAX init's tree drawn with
numpy at the init's scales (1/√din, times 1e-2 for adaLN, the row-parallel
outputs and the head, as ``init_dit_params``; the router at full scale for
a routing margin), biases N(0, 0.02) where the init has zeros so that a
misplaced bias shows, and carried across by ``dit_params_from_jax``. The JAX
side is the unsharded ``dit_apply`` (and the unsharded sampler); JAX's
``dit_param_shardings`` is only read for its specs on the 8-device virtual
CPU mesh. The refusals are held to the exception types the JAX package's
``dit_pp_apply`` raises for the same misuse (it raises before compiling).

Tolerances are those of tests/test_dit.py, at the scales of its init: 1e-5
relative and 1e-6 absolute elementwise; the MoE aux at least 1 − 1e-5 and
within 1e-6 of the unsharded aux. (At full-scale weights, outputs up to 3.6,
even the unsharded port differs from JAX by 4.7e-6: sums in another order.)
MoE routing is an argmax: the cases state the margin precondition of
tests/test_torch_dit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import sonar_tpu.models.dit as jd
import sonar_tpu.samplers.sonar as js
import sonar_tpu_torch.models.dit as td
import sonar_tpu_torch.parallel as tp
from _parallel_worlds import _sigmas, dit_world
from sonar_tpu.parallel import make_mesh as jmesh
from test_torch_dit import MARGIN, _router_margin

RANKS = 8
DENSE = dict(hidden=64, depth=4, num_heads=4, patch_size=2)
MOE = dict(hidden=64, depth=2, num_heads=4, patch_size=2, num_experts=4, capacity_factor=4.0)
SMALL = ("ada", "attn_out", "mlp_out", "final")  # the init's 1e-2 layers


def _params(cfg_kw, seed):
    """The JAX init's tree (shapes only) drawn with numpy at the init's scales."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        keys = [k.key for k in path]
        if keys[-1] == "b":
            return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
        scale = 1e-2 if any(k in SMALL for k in keys) else 1.0
        return (rng.standard_normal(a.shape) * scale / np.sqrt(a.shape[-2])).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jd.init_dit_params(k, jd.DiTConfig(**cfg_kw)),
                            jax.random.key(seed))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    dense, moe = _params(DENSE, 0), _params(MOE, 3)
    data = {
        "dense_cfg": DENSE, "moe_cfg": MOE,
        "dense": {k: v.numpy() for k, v in td.dit_params_from_jax(dense).items()},
        "moe": {k: v.numpy() for k, v in td.dit_params_from_jax(moe).items()},
        "x4": rng.standard_normal((4, 4, 16, 16)).astype(np.float32),
        "s4": np.linspace(0.5, 3.0, 4).astype(np.float32),
        "x8": rng.standard_normal((8, 4, 16, 16)).astype(np.float32),
        "s8": np.linspace(0.2, 6.0, 8).astype(np.float32),
        "x_serve": (rng.standard_normal((2, 4, 16, 16)) * 14.6).astype(np.float32),
        "serve_noise": [rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
                        for _ in range(len(_sigmas()) - 1)],
    }
    return {"data": data, "dense": dense, "moe": moe}


@pytest.fixture(scope="module")
def world(setup):
    return tp.run_world(dit_world, RANKS, backend="gloo", device_type="cpu",
                        args=(setup["data"],))


@pytest.fixture(scope="module")
def jax_apply():
    cache = {}

    def run(params, cfg_kw, x, s, aux=False):
        key = (tuple(sorted(cfg_kw.items())), x.shape, aux)
        if key not in cache:
            cfg = jd.DiTConfig(**cfg_kw)
            cache[key] = jax.jit(lambda p, a, b: jd.dit_apply(p, a, b, cfg, return_aux=aux))
        return jax.tree.map(np.asarray, cache[key](params, jnp.asarray(x), jnp.asarray(s)))

    return run


FORWARDS = {  # case: (config, input)
    "pp2": ("dense", "x4"), "pp4": ("dense", "x4"), "pp2xdp2": ("dense", "x8"),
    "pp2xtp2": ("dense", "x4"), "tp2xdp2": ("dense", "x4"), "tp4xdp2": ("dense", "x4"),
    "ep2": ("moe", "x4"), "ep2xdp2": ("moe", "x4"), "ep4xdp2": ("moe", "x4"),
    "moe_pp2": ("moe", "x4"),
}


@pytest.mark.parametrize("case", list(FORWARDS))
def test_sharded_forward_matches_jax(world, setup, jax_apply, case):
    """Every rank's output rows equal JAX's unsharded forward: pp with 2 and
    4 stages (2 microbatches), pp × dp, pp × tp, tp 2 and 4 with dp, ep 2
    and 4 (with dp) and MoE blocks under pp. The MoE aux: under ep the
    unsharded aux (the router sees every expert on every rank); under pp the
    per-microbatch formulation of the JAX package's pipeline, the mean of
    the unsharded aux over the microbatches."""
    which, xk = FORWARDS[case]
    cfg_kw = DENSE if which == "dense" else MOE
    x, s = setup["data"][xk], setup["data"]["s" + xk[1:]]
    params = setup[which]
    if which == "moe":  # the routing precondition, on the port's module
        model = td.DiT(td.DiTConfig(**cfg_kw))
        model.load_state_dict(td.dit_params_from_jax(params))
        assert _router_margin(model.eval(), x, s) >= MARGIN
    ref, ref_aux = jax_apply(params, cfg_kw, x, s, aux=True)
    held = [r[case] for r in world if r[case] is not None]
    assert held
    for got in held:
        rows = slice(got["first"], got["first"] + got["eps"].shape[0])
        np.testing.assert_allclose(got["eps"], ref[rows], rtol=1e-5, atol=1e-6)
    if which == "moe":
        if case.startswith("ep"):
            want = float(ref_aux)
        else:  # two microbatches of two rows
            want = np.mean([float(jax_apply(params, cfg_kw, x[i:i + 2], s[i:i + 2],
                                            aux=True)[1]) for i in (0, 2)])
        for got in held:
            assert got["aux"] >= 1.0 - 1e-5
            assert abs(got["aux"] - want) <= 1e-6 * max(1.0, abs(want)), (got["aux"], want)


def test_pipelined_denoiser_serves_the_sampler(world, setup):
    """make_dit_denoiser(pp_mesh=) under dp=2 × pp=2 serving
    sonar_euler_ancestral on injected noise, against JAX's unsharded sampler
    on its unsharded DiT."""
    data = setup["data"]
    cfg = jd.DiTConfig(**DENSE)
    stacked = jnp.asarray(np.stack(data["serve_noise"]))
    ref = np.asarray(js.sample_sonar_euler_ancestral(
        jd.make_dit_denoiser(setup["dense"], cfg), jnp.asarray(data["x_serve"]),
        jnp.asarray(_sigmas()), noise_sampler=lambda i, s, sn: stacked[i]))
    held = [r["serve_dp2xpp2"] for r in world if r["serve_dp2xpp2"] is not None]
    assert len(held) == 4
    for got in held:
        rows = slice(got["first"], got["first"] + got["x"].shape[0])
        np.testing.assert_allclose(got["x"], ref[rows], rtol=1e-5, atol=1e-5)


def _port_dims(jax_path: tuple, staged: bool, ndim: int) -> dict:
    """JAX tensor dimension -> the port's, for one leaf: the block stack's
    leading axes become the port stack's dimension 0 and dense weights are
    transposed (the JAX tree's (din, dout) is nn.Linear's (dout, din))."""
    lead = (2 if staged else 1) if jax_path[0] == "blocks" else 0
    body = ndim - lead
    dense_w = jax_path[-1] == "w" and body == 2
    dims = {d: 0 for d in range(lead)}
    for d in range(body):
        dims[lead + d] = (lead and 1) + ((1 - d) if dense_w else d)
    return dims


LAYOUTS = {  # case: (config, mesh axes, mesh shape, kwargs, staged in JAX)
    "dense_tp": ("dense", ("dp", "tp"), (2, 4), dict(tp="tp"), False),
    "dense_pp": ("dense", ("dp", "pp"), (2, 4), dict(tp=None, pp="pp"), True),
    "dense_pp_tp": ("dense", ("pp", "tp"), (2, 4), dict(tp="tp", pp="pp"), True),
    "moe_ep": ("moe", ("dp", "ep"), (2, 4), dict(tp=None, ep="ep"), False),
    "moe_ep_tp": ("moe", ("ep", "tp"), (4, 2), dict(tp="tp", ep="ep"), False),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_param_shardings_mirror_jax(world, setup, case):
    """dit_param_shardings names, for every parameter, the placements of the
    JAX package's spec for the same leaf (block leaves as the stack over the
    blocks, dense weights transposed)."""
    which, names, shape, kw, staged = LAYOUTS[case]
    params = setup[which]
    mesh = jmesh(8, axis_names=names, mesh_shape=shape)
    if staged:
        params = jd.pp_stage_params(params, shape[names.index("pp")])
    specs = jd.dit_param_shardings(params, mesh, **kw)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda v: isinstance(v, NamedSharding))[0]:
        keys = tuple(k.key for k in path)
        ndim = np.ndim(_leaf(params, keys))
        dims = _port_dims(keys, staged, ndim)
        plc = ["R"] * len(names)
        for d, axis in enumerate(tuple(sh.spec) + (None,) * (ndim - len(tuple(sh.spec)))):
            if axis is not None:
                plc[names.index(axis)] = f"S({dims[d]})"
        port = (*keys[:-1], {"w": "weight", "b": "bias"}[keys[-1]])
        want[".".join(("blocks", "*", *port[1:]) if port[0] == "blocks" else port)] = tuple(plc)
    for r in world:
        assert r["shardings"][case] == want


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _jax_refusal(name, dense, moe):
    x2, x4 = jnp.zeros((2, 4, 16, 16)), jnp.zeros((4, 4, 16, 16))
    dcfg, mcfg = jd.DiTConfig(**DENSE), jd.DiTConfig(**MOE)
    if name == "stages":
        return lambda: jd.dit_pp_apply(jd.pp_stage_params(dense, 4), x2, jnp.ones((2,)), dcfg,
                                       jmesh(2, axis_names=("pp",)), microbatches=1, dp=None)
    if name == "unstaged":
        return lambda: jd.dit_pp_apply(dense, x2, jnp.ones((2,)), dcfg,
                                       jmesh(2, axis_names=("pp",)), microbatches=1, dp=None)
    if name == "depth":
        return lambda: jd.pp_stage_params(dense, 3)
    if name == "tp_moe":
        return lambda: jd.dit_pp_apply(
            jd.pp_stage_params(moe, 2), x4, jnp.ones((4,)), mcfg,
            jmesh(4, axis_names=("pp", "tp"), mesh_shape=(2, 2)), microbatches=2, dp=None,
            tp="tp")
    if name == "heads":
        return lambda: jd.dit_pp_apply(
            jd.pp_stage_params(dense, 1), x4, jnp.ones((4,)), dcfg,
            jmesh(3, axis_names=("pp", "tp"), mesh_shape=(1, 3)), microbatches=2, dp=None,
            tp="tp")
    if name == "microbatches":
        return lambda: jd.dit_pp_apply(
            jd.pp_stage_params(dense, 4), jnp.zeros((8, 4, 16, 16)), jnp.ones((8,)), dcfg,
            jmesh(8, axis_names=("dp", "pp"), mesh_shape=(2, 4)), microbatches=8)

    def other_axis():
        mesh = jmesh(8, axis_names=("ep", "pp"), mesh_shape=(4, 2))
        staged = jd.pp_stage_params(moe, 2)
        staged = jax.tree_util.tree_map(
            jax.device_put, staged,
            jd.dit_param_shardings(staged, mesh, tp=None, pp="pp", ep="ep"))
        jd.dit_pp_apply(staged, x4, jnp.ones((4,)), mcfg, mesh, microbatches=2, dp=None)

    return other_axis


@pytest.mark.parametrize("name", ["stages", "unstaged", "depth", "tp_moe", "heads",
                                  "microbatches", "other_axis"])
def test_refusals_match_jax(world, setup, name):
    """The pipeline's refusals: a stage count other than the mesh's (and an
    unstaged DiT), a depth the stages do not divide, tp with MoE blocks, heads
    that tp does not divide, a local batch the microbatches do not divide,
    blocks split on another axis: the port raises the JAX package's type."""
    with pytest.raises(Exception) as e:
        _jax_refusal(name, setup["dense"], setup["moe"])()
    held = [r["refusals"].get(name) for r in world if r["refusals"].get(name) is not None]
    assert held
    for kind, msg in held:
        assert kind == type(e.value).__name__, (kind, msg, e.value)
    if name == "microbatches":
        assert "per-shard batch 4" in held[0][1]
