"""The parallel tier's training half against the JAX package: the UNet's
tensor-parallel and FSDP layouts through a sharded training step, the MoE
DiT's step under dp and ep, the DiT's gradients through its pipeline (the
MoE's under pp × dp), checkpoints restored onto sharded targets, and a
``NoiseChain`` drawn on dp shards. Inside the ranks a backward through an op
with no autograd formula fails (torch would pass the gradient on unchanged
with a warning).

One gloo world of 4 CPU ranks (``parallel.run_world``) runs every case once
(``tests/_parallel_worlds.parallel_train_world``); each test reads its case
from the ranks' results. The JAX side is the unsharded function: the JAX
package's own tests (tests/test_sharding.py, test_dit.py, test_train.py)
hold its sharded layouts equal to it. The layouts are checked leaf by leaf
against JAX's ``_param_spec``/``_fsdp_spec``, which are pure functions of
(path, leaf) and need no device mesh.

The UNet is tests/test_sharding.py:81-82's small configuration at
4×4×16×16, its weights the JAX init's tree drawn with numpy
(``_train_compare.family``); the port's draws are JAX's, each rank given its
rows of them. Tolerances: the step's loss 1e-6 relative and each gradient
block within 1e-4 of its whole leaf's largest value, against JAX's
unsharded step (those of tests/test_torch_train_unet.py); the FSDP step's
loss within 1e-5 relative of the replicated layout's (test_sharding.py:
272-273); DiT gradients 2e-5 relative and absolute elementwise
(test_dit.py:111-113), the MoE's steps and pipeline gradients as the
UNet's step (routing margin ``_train_compare.MARGIN``); restores bit for
bit; the chain's trajectory 1e-5 relative to max(1, |JAX|) and its draws
1e-6 (the sharded normalization's sums run in another order).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import sonar_tpu.models.dit as jd
import sonar_tpu.models.unet as ju
import sonar_tpu.parallel.mesh as jm
import sonar_tpu.samplers.sonar as js
import sonar_tpu_torch.models.dit as td
import sonar_tpu_torch.models.train as tt
import sonar_tpu_torch.samplers.sonar as ts
from _parallel_worlds import _recording, _sigmas, _stub, parallel_train_world
from _train_compare import DIT, MARGIN, MOE, UNET, family, jax_draws, jax_loss_grads
from sonar_tpu.parallel import make_mesh as jmesh
from sonar_tpu_torch.models import (init_train_state, make_train_step, restore_checkpoint,
                                    save_checkpoint)
from sonar_tpu_torch.noise import NoiseChain, get_noise_item
from sonar_tpu_torch.parallel import run_world
from test_torch_dit_parallel import DENSE, _params

RANKS = 4
BATCH = (4, 4, 16, 16)
SEED = 3
LAYOUTS = {"dp2xtp2": (2, 2, False), "fsdp_dp2xtp2": (2, 2, True), "fsdp_dp4": (4, 1, True)}
REFUSAL_CFG = dict(model_channels=16, channel_mult=(1,), num_res_blocks=1, attention_levels=(),
                   norm_groups=4)  # test_sharding.py:298-300
_PLACEMENT = re.compile(r"Shard\(dim=(\d+)\)|Replicate\(\)")


def _adam(model):
    return init_train_state(model, functools.partial(torch.optim.Adam, lr=2e-3))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    _, jparams, model, to_port = family("unet", UNET)
    batch = np.random.default_rng(1).standard_normal(BATCH).astype(np.float32)
    u, eps = jax_draws(SEED, batch)
    step = make_train_step(model.cfg)
    # the unsharded state a step in, saved: the sharded restores read it
    opt = _adam(model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "train_draws", lambda seed, b: (u, eps))
        step(model, opt, torch.from_numpy(batch), SEED)
        grads1 = {k: p.grad.clone() for k, p in model.named_parameters()}
        ckpt = tmp_path_factory.mktemp("ckpt") / "state"
        save_checkpoint(ckpt, {"params": model.state_dict(), "opt_state": opt.state_dict(),
                               "step": 1})
        saved = {"params": {k: v.clone() for k, v in model.state_dict().items()},
                 "moments": [(s["exp_avg"].clone(), s["exp_avg_sq"].clone())
                             for s in opt.state_dict()["state"].values()]}
        resumed = float(step(model, opt, torch.from_numpy(batch), 4))
        grads2 = {k: p.grad.clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(0)
    dense = _params(DENSE, 0)
    dit, moe = family("dit", DIT), family("dit", MOE)
    data = {
        "unet_cfg": UNET, "unet": {k: v.numpy() for k, v in to_port(jparams).items()},
        "batch": batch, "u": u.numpy(), "eps": eps.numpy(), "refusal_cfg": REFUSAL_CFG,
        "ckpt": str(ckpt),
        "dit_cfg": DIT, "dit": {k: v.numpy() for k, v in dit[3](dit[1]).items()},
        "moe_cfg": MOE, "moe": {k: v.numpy() for k, v in moe[3](moe[1]).items()},
        "dense_cfg": DENSE,
        "dense": {k: v.numpy() for k, v in td.dit_params_from_jax(dense).items()},
        "x4": rng.standard_normal((4, 4, 16, 16)).astype(np.float32),
        "s4": np.linspace(0.5, 3.0, 4).astype(np.float32),
        "x_chain": (rng.standard_normal(BATCH) * 14.6).astype(np.float32),
        "target": np.arange(np.prod(BATCH), dtype=np.float32).reshape(BATCH) / 1e3,
    }
    return {"data": data, "batch": batch, "dense": dense, "saved": saved, "grads1": grads1,
            "resumed": (resumed, grads2), "ckpt": ckpt}


@pytest.fixture(scope="module")
def world(setup):
    return run_world(parallel_train_world, RANKS, backend="gloo", device_type="cpu",
                     args=(setup["data"],))


def _block(whole: np.ndarray, placements: str, coord, sizes, skip_dim0: bool = False):
    """The block of ``whole`` a rank at mesh ``coord`` (axis sizes ``sizes``)
    holds under ``placements`` (``str`` of the tuple, one entry per axis);
    ``skip_dim0``: dimension 0 of the placements is the DiT's block axis."""
    idx = [slice(None)] * whole.ndim
    for m, c, n in zip(_PLACEMENT.finditer(placements), coord, sizes):
        if m.group(1) is None:
            continue
        d = int(m.group(1)) - (1 if skip_dim0 else 0)
        if d >= 0:
            k = whole.shape[d] // n
            idx[d] = slice(c * k, (c + 1) * k)
    return whole[tuple(idx)]


def _jax_placements(path, leaf, dp_size: int, fsdp: bool) -> str:
    """JAX's spec of a UNet leaf in the port's weight layout, as the port's
    placements on a ("dp", "tp") mesh."""
    spec = jm._param_spec(path, leaf)
    if fsdp and dp_size > 1:
        spec = jm._fsdp_spec(spec, leaf, dp_size, "dp")
    spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
    perm = {2: (1, 0), 4: (2, 3, 1, 0)}.get(leaf.ndim)
    plc = []
    for axis in ("dp", "tp"):
        dims = [d for d, a in enumerate(spec) if a == axis]
        plc.append(Shard(perm[dims[0]]) if dims else Replicate())
    return str(tuple(plc))


def _jax_shapes(cfg_kw):
    """The JAX UNet's parameter tree, shapes only."""
    return jax.eval_shape(lambda k: ju.init_unet_params(k, ju.UNetConfig(**cfg_kw)),
                          jax.random.key(0))


def _port_name(path) -> str:
    *parent, leaf = [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]
    return ".".join((*parent, {"w": "weight", "scale": "weight", "b": "bias"}.get(leaf, leaf)))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unet_shardings_match_jax(world, layout):
    """unet_param_shardings names, leaf for leaf, the dimension JAX's
    _param_spec (and _fsdp_spec, whose ties go to the first of the largest in
    the JAX dimension order) shards, transposed to the port's layouts."""
    dp, _, fsdp = LAYOUTS[layout]
    shapes = _jax_shapes(UNET)
    want = {_port_name(path): _jax_placements(path, leaf, dp, fsdp)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for r in world:
        assert r[layout]["placements"] == want
    if fsdp:
        assert any("Shard" in v.split(",")[0] for v in want.values())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_unet_step_matches_jax(world, setup, layout):
    """The sharded step (dp × tp, tp + FSDP over dp, FSDP over dp=4) on JAX's
    draws, each rank its rows: the whole batch's loss, and each rank's
    gradient blocks those of JAX's unsharded step."""
    dp, tp, _ = LAYOUTS[layout]
    jloss, want = jax_loss_grads("unet", UNET, {}, setup["batch"], SEED)
    for r in world:
        res = r[layout]
        assert abs(res["loss"] - jloss) <= 1e-6 * abs(jloss)
        assert set(res["grads"]) == set(want)
        for k, w in want.items():
            whole = w.double().numpy()
            got = res["grads"][k].astype(np.float64)
            block = _block(whole, res["placements"][k], res["coord"], (dp, tp))
            assert got.shape == block.shape, (k, got.shape, block.shape)
            err = float(np.abs(got - block).max())
            assert err <= 1e-4 * max(float(np.abs(whole).max()), 1e-12), (layout, k, err)
        _adam_first_step_close(res, setup, (dp, tp))


def _adam_first_step_close(res, setup, sizes):
    """The weights after the first Adam step against the unsharded step's:
    Adam's first update is lr·g/(|g| + eps), which moves by at most
    lr·|Δg|/(min(|g|, |g'|) + eps) when the gradient moves by Δg; so each
    weight lies within that (on the two steps' own gradients) of the
    unsharded one, plus 8 ulps of lr (each side forms the update in about
    eight float32 roundings of at most half an ulp) and an ulp of the weight
    a side."""
    lr, eps = 2e-3, 1e-8
    for k, p in setup["saved"]["params"].items():
        plc = res["placements"][k]
        want = _block(p.double().numpy(), plc, res["coord"], sizes)
        g_u = _block(setup["grads1"][k].double().numpy(), plc, res["coord"], sizes)
        g_s = res["grads"][k].astype(np.float64)
        bound = (lr * np.abs(g_s - g_u) / (np.minimum(np.abs(g_s), np.abs(g_u)) + eps)
                 + 8 * np.spacing(np.float32(lr))
                 + 2 * np.spacing(np.abs(want).astype(np.float32)))
        diff = np.abs(res["params"][k] - want)
        i = np.unravel_index(np.argmax(diff - bound), diff.shape)
        assert np.all(diff <= bound), (k, diff[i], bound[i], g_s[i], g_u[i], want[i])


def test_fsdp_step_keeps_its_layout_and_the_replicated_loss(world):
    """FSDP is the same step in another layout: its loss equals the
    replicated layout's, its weights keep their blocks through the optimizer
    step, at least one weight per rank is split on dp, and 1-D leaves stay
    whole (the small-leaf exemption)."""
    for r in world:
        rep, fs = r["dp2xtp2"], r["fsdp_dp2xtp2"]
        np.testing.assert_allclose(fs["loss"], rep["loss"], rtol=1e-5, atol=1e-6)
        before, after = fs["shapes"]
        assert before == after
        assert fs["fsdp_params"] and rep["fsdp_params"] == []
        for k, plc in fs["placements"].items():
            on_dp = "Shard" in plc.split(",")[0]
            assert on_dp == (k in fs["fsdp_params"])
            if k.endswith("bias") or ".norm" in k:
                assert not on_dp, k


def test_fsdp_requires_the_axis(world):
    """fsdp=True on a mesh without the FSDP axis raises JAX's ValueError;
    naming the axis shards on it. A step of the FSDP layout on a batch not
    split on its axis raises too (its gradient sums would count each batch
    row once a rank)."""
    mesh = jmesh(8, axis_names=("data", "tp"))
    shapes = _jax_shapes(REFUSAL_CFG)
    with pytest.raises(ValueError, match="no 'dp' axis") as raised:
        jm.unet_param_shardings(shapes, mesh, fsdp=True)
    for r in world:
        assert r["refusal"] == ("ValueError", str(raised.value))
        assert any(v.startswith("(Shard") for v in r["refusal_named"].values())
        kind, msg = r["refusal_batch"]
        assert kind == "ValueError" and "FSDP" in msg


@pytest.mark.parametrize("case", ["dit_pp2", "dit_pp2xtp2"])
def test_dit_grads_through_the_pipeline(world, setup, case):
    """torch.autograd through dit_pp_apply is pipeline backprop: each stage's
    gradients (tp blocks under pp × tp, the embedding and head whole on
    every stage) equal jax.grad of the unsharded dit_apply."""
    cfg = jd.DiTConfig(**DENSE)
    x, s = jnp.asarray(setup["data"]["x4"]), jnp.asarray(setup["data"]["s4"])
    g = jax.grad(lambda p: jnp.sum(jd.dit_apply(p, x, s, cfg) ** 2))(setup["dense"])
    want = {k: v.numpy() for k, v in td.dit_params_from_jax(jax.tree.map(np.asarray, g)).items()}
    n_stage = DENSE["depth"] // 2
    seen = 0
    for r in world:
        res = r[case]
        if res is None:
            continue
        seen += 1
        coord = res["coord"]
        for k, got in res["grads"].items():
            parts = k.split(".")
            if parts[0] == "blocks":
                key = ".".join(["blocks", str(coord["pp"] * n_stage + int(parts[1])), *parts[2:]])
                plc = res["placements"][".".join(["blocks", "*", *parts[2:]])]
                block = _block(want[key], plc, list(coord.values()), (2,) * len(coord),
                               skip_dim0=True)
            else:
                block = want[k]
            np.testing.assert_allclose(got, block, rtol=2e-5, atol=2e-5, err_msg=k)
    assert seen == (2 if case == "dit_pp2" else 4)


def test_dit_train_step_through_the_pipeline(world, setup):
    """make_train_step on DiT stages (pp=2 × tp=2, 2 microbatches), the
    batch whole on every rank, on JAX's draws: JAX's unsharded step's loss
    and, block by block, its gradients."""
    jloss, want = jax_loss_grads("dit", DIT, {}, setup["batch"], SEED)
    n_stage = DIT["depth"] // 2
    for r in world:
        res = r["dit_step_pp2xtp2"]
        assert abs(res["loss"] - jloss) <= 1e-6 * abs(jloss)
        coord = res["coord"]
        for k, got in res["grads"].items():
            parts = k.split(".")
            key, plc = k, res["placements"].get(k)
            if parts[0] == "blocks":
                key = ".".join(["blocks", str(coord["pp"] * n_stage + int(parts[1])), *parts[2:]])
                plc = res["placements"][".".join(["blocks", "*", *parts[2:]])]
            whole = want[key].double().numpy()
            block = _block(whole, plc, list(coord.values()), (2, 2), skip_dim0=parts[0] == "blocks")
            err = float(np.abs(got.astype(np.float64) - block).max())
            assert err <= 1e-4 * max(float(np.abs(whole).max()), 1e-12), (k, err)


def _close_blocks(res, want, sizes, rel, n_stage=MOE["depth"]):
    """Each gradient block of a DiT rank's result within ``rel`` of its whole
    leaf's largest value (a stage's blocks are keyed by their index in it,
    ``n_stage`` blocks a stage)."""
    coord = res["coord"]
    for k, got in res["grads"].items():
        parts = k.split(".")
        key, plc = k, res["placements"][k] if parts[0] != "blocks" else None
        if parts[0] == "blocks":
            key = ".".join(["blocks", str(coord.get("pp", 0) * n_stage + int(parts[1])),
                            *parts[2:]])
            plc = res["placements"][".".join(["blocks", "*", *parts[2:]])]
        whole = want[key].double().numpy()
        block = _block(whole, plc, list(coord.values()), sizes, skip_dim0=parts[0] == "blocks")
        assert got.shape == block.shape, (k, got.shape, block.shape)
        err = float(np.abs(got.astype(np.float64) - block).max())
        assert err <= rel * max(float(np.abs(whole).max()), 1e-12), (k, err)


MOE_LAYOUTS = {"moe_dp2": (2,), "moe_ep2": (2,), "moe_dp2xep2": (2, 2)}


@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
def test_moe_train_step_under_dp_and_ep(world, setup, layout):
    """The Switch-MoE DiT's training step (aux weight 0.1) with its batch
    split on dp, its experts split on ep, and both, on JAX's draws: JAX's
    unsharded step's loss and, block by block, its gradients. Under dp the
    load-balance loss is the whole batch's, and its gradient reaches the
    router through the routing means summed over dp. Routing is an argmax:
    every token's top two router probabilities are MARGIN apart."""
    jloss, want = jax_loss_grads("dit", MOE, dict(aux_weight=0.1), setup["batch"], SEED)
    seen = 0
    for r in world:
        res = r[layout]
        if res is None:
            continue
        seen += 1
        assert res["gap"] >= MARGIN
        assert abs(res["loss"] - jloss) <= 1e-6 * abs(jloss)
        _close_blocks(res, want, MOE_LAYOUTS[layout], 1e-4)
    assert seen == np.prod(MOE_LAYOUTS[layout])


def test_moe_grads_through_the_pipeline_under_dp(world, setup):
    """torch.autograd through dit_pp_apply for the MoE DiT at pp=2 × dp=2
    (2 microbatches of one row a rank), loss mean(eps²) + aux, the gradients
    summed over dp: jax.grad of the unsharded function the JAX pipeline
    computes there. Its eps is dit_apply's (routing and capacity are per
    sample); its aux is the mean over the dp shards of the mean over the
    microbatches of the stages' mean block aux, with equal stages the mean
    over the four one-row chunks of dit_apply's aux. Tolerances as the train
    step's: loss 1e-6 relative, each gradient block within 1e-4 of its
    leaf's largest value."""
    data = setup["data"]
    cfg = jd.DiTConfig(**MOE)
    x, s = jnp.asarray(data["x4"]), jnp.asarray(data["s4"])

    def loss(p):
        eps = jd.dit_apply(p, x, s, cfg)
        aux = jnp.mean(jnp.stack([jd.dit_apply(p, x[i:i + 1], s[i:i + 1], cfg,
                                               return_aux=True)[1] for i in range(x.shape[0])]))
        return jnp.mean(eps**2) + aux

    jloss, g = jax.jit(jax.value_and_grad(loss))(family("dit", MOE)[1])
    want = td.dit_params_from_jax(jax.tree.map(np.asarray, g))
    for r in world:
        res = r["moe_pp2xdp2"]
        assert res["gap"] >= MARGIN
        assert abs(res["loss"] - float(jloss)) <= 1e-6 * abs(float(jloss))
        _close_blocks(res, want, (2, 2), 1e-4, n_stage=MOE["depth"] // 2)


@pytest.mark.parametrize("layout", ["replicated", "fsdp"])
def test_sharded_restore_is_bit_exact(world, setup, layout):
    """restore_checkpoint onto a sharded target: each rank's blocks (the
    whole tensors when replicated; the FSDP layout's blocks of the weights
    and of Adam's moments) are the saved tensors' slices, bit for bit."""
    saved = setup["saved"]["params"]
    for r in world:
        if layout == "replicated":
            assert r["restore_types"] == ["DTensor"]
            for k, v in saved.items():
                np.testing.assert_array_equal(r["restore_replicated"][k], v.numpy())
            continue
        plc = r["fsdp_dp2xtp2"]["placements"]
        for k, v in saved.items():
            np.testing.assert_array_equal(r["restore_fsdp"][k],
                                          _block(v.numpy(), plc[k], r["restore_coord"], (2, 2)))
        for i, k in enumerate(saved):
            for got, want in zip(r["restore_fsdp_moments"][k], setup["saved"]["moments"][i]):
                np.testing.assert_array_equal(
                    got, _block(want.numpy(), plc[k], r["restore_coord"], (2, 2)))


def test_resumed_fsdp_step_equals_the_unsharded_one(world, setup):
    """A step resumed on the FSDP layout from the restored blocks (params and
    Adam's state): the unsharded resumed step's loss and gradients, and its
    update is Adam's on the whole tensors (from the saved state, with the
    ranks' gradient blocks put together), bit for bit on every block."""
    loss, grads = setup["resumed"]
    plc = world[0]["fsdp_dp2xtp2"]["placements"]
    whole = {k: np.zeros(g.shape, np.float32) for k, g in grads.items()}
    for r in world:
        assert abs(r["resumed_loss"] - loss) <= 1e-6 * abs(loss)
        for k, g in grads.items():
            want = _block(g.double().numpy(), plc[k], r["restore_coord"], (2, 2))
            got = r["resumed_grads"][k]
            assert np.abs(got - want).max() <= 1e-4 * max(float(g.abs().max()), 1e-12), k
            _block(whole[k], plc[k], r["restore_coord"], (2, 2))[...] = got
    model = family("unet", UNET)[2]
    opt = _adam(model)
    state = restore_checkpoint(setup["ckpt"], target={"params": model.state_dict(),
                                                      "opt_state": None, "step": None})
    model.load_state_dict(state["params"])
    opt.load_state_dict(state["opt_state"])
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(whole[k])
    opt.step()
    for r in world:
        for k, p in model.named_parameters():
            np.testing.assert_array_equal(
                r["resumed_params"][k], _block(p.detach().numpy(), plc[k], r["restore_coord"],
                                               (2, 2)), err_msg=k)


def test_noise_chain_under_dp_matches_jax(world, setup):
    """NoiseChain([gaussian, pyramid]) on a latent split over dp=4 (the JAX
    package's tests/test_sharding.py:27-46, :111-126 case): each rank's draws
    are its rows of the unsharded chain's, and the rows together step JAX's
    unsharded trajectory on those draws."""
    data = setup["data"]
    chain = NoiseChain([get_noise_item("gaussian"), get_noise_item("pyramid")])
    draws: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "make_noise_sampler", _recording(draws))
        ts.sample_sonar_euler_ancestral(_stub(data["target"]), torch.from_numpy(data["x_chain"]),
                                        torch.from_numpy(_sigmas()), noise_item=chain, seed=0)
    for i, d in enumerate(draws):
        got = np.concatenate([r["chain"]["draws"][i] for r in world])
        assert np.abs(got - d).max() <= 1e-6 * max(1.0, float(np.abs(d).max()))
    t = jnp.asarray(data["target"])
    stacked = jnp.asarray(np.stack(draws))
    ref = np.asarray(js.sample_sonar_euler_ancestral(
        lambda x, s, **_: (x * 0.9 + t) / (1.0 + jnp.reshape(s, (-1, 1, 1, 1)) * 0.05),
        jnp.asarray(data["x_chain"]), jnp.asarray(_sigmas()),
        noise_sampler=lambda i, s, sn: stacked[i]))
    got = np.concatenate([r["chain"]["x"] for r in world])
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, float(np.abs(ref).max()))
    for r in world:
        assert r["chain"]["placements"] == "(Shard(dim=0),)"
        kind, msg = r["chain_refused"]
        assert kind == "NotImplementedError" and "NoiseChain" in msg

