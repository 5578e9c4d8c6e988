"""What the ranks of the parallel tests' gloo worlds run (spawned by
``sonar_tpu_torch.parallel.run_world``; the test files compare the results
with the JAX package's unsharded functions in the parent process).

Each world function takes plain numpy inputs, runs every case of its file in
one world and returns, per rank, a dict of numpy results keyed by case. It
imports the port and torch only: the spawned ranks never load JAX.
"""

from __future__ import annotations

import math
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().numpy().copy()


def _raised(fn) -> tuple[str, str] | None:
    """(exception type, message) of ``fn()``, or None if it returned."""
    try:
        fn()
    except Exception as e:  # the test compares the type with the JAX package's
        return type(e).__name__, str(e)
    return None


def _sigmas():
    return np.asarray([14.6, 5.0, 1.0, 0.3, 0.0], np.float32)


def _stub(target):
    """A denoiser of the sampler tests' kind, on this rank's rows of ``target``."""
    t = torch.from_numpy(target)
    return lambda x, s, **_: (x * 0.9 + t) / (1.0 + s.reshape(-1, 1, 1, 1) * 0.05)


# -- tests/test_torch_parallel.py ------------------------------------------------------------


def parallel_world(data: dict) -> dict:
    """Every case of ``test_torch_parallel.py`` in one 4-rank world."""
    from torch.distributed.tensor import DTensor, Shard

    from sonar_tpu_torch.api import SonarPipeline
    from sonar_tpu_torch.core.normalize import scale_noise
    from sonar_tpu_torch.kernels.hwrng import philox_rand, philox_randn
    from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler
    from sonar_tpu_torch.noise.base import NoiseItem
    from sonar_tpu_torch.parallel import LatentShard, make_mesh, placements, shard_latent
    from sonar_tpu_torch.samplers.sonar import (sample_sonar_euler,
                                                sample_sonar_euler_ancestral)

    out: dict = {"rank": dist.get_rank()}
    # make_mesh's factoring over the first n ranks (ranks outside skip nothing:
    # every rank builds every mesh)
    out["factoring"] = {
        (n, names): tuple(make_mesh(n, axis_names=names, device_type="cpu").shape)
        for n in (1, 2, 3, 4) for names in (("dp", "tp"), ("dp",), ("dp", "tp", "sp"))}

    mesh = make_mesh(axis_names=("dp",), device_type="cpu")
    x0 = torch.from_numpy(data["x0"])
    xs = shard_latent(x0, mesh)
    b0 = LatentShard.of(xs).offset[0]
    rows = slice(b0, b0 + xs.to_local().shape[0])
    noises = data["noises"]
    injected = lambda i, s, sn: torch.from_numpy(noises[i][rows])  # noqa: E731
    sig = torch.from_numpy(_sigmas())
    model = _stub(data["target"][rows])
    res = sample_sonar_euler_ancestral(model, xs, sig, noise_sampler=injected)
    out["placements"] = (str(res.placements), str(xs.placements), tuple(res.shape))
    out["ancestral"] = _np(res.to_local())
    out["euler"] = _np(sample_sonar_euler(model, xs, sig).to_local())
    # the channel axis on dp (what a wrong latent_spec would give): the
    # sampler keeps it, and it is not the latent's layout
    wrong = DTensor.from_local(x0.chunk(4, dim=1)[dist.get_rank()].contiguous(), mesh,
                               (Shard(1),), run_check=False, shape=x0.shape, stride=x0.stride())
    out["wrong_placements"] = str(sample_sonar_euler_ancestral(
        lambda x, s, **_: x * 0.9, wrong, sig,
        noise_sampler=lambda i, s, sn: torch.zeros(wrong.to_local().shape)).placements)
    out["latent_placements"] = str(placements(mesh, ("dp", None, None, None)))

    # the port's own Philox stream, sharded on dp and on sp, against its unsharded draw
    draws = {}
    sp_mesh = make_mesh(axis_names=("dp", "sp"), mesh_shape=(1, 4), device_type="cpu")
    for what, shape, m, sp in (("dp", (4, 4, 16, 16), mesh, None),
                               ("dp ragged", (4, 3, 5, 7), mesh, None),
                               ("sp", (1, 4, 8, 16, 16), sp_mesh, "sp")):
        sh = LatentShard.of(shard_latent(torch.zeros(shape), m, sp=sp))
        runs = sh.runs(shape[-2], shape[-1])
        draws[what] = {
            "box": (sh.offset, sh.local_shape),
            "rand": _np(philox_rand(11, sh.local_shape, device="cpu", shard=runs)),
            "randn": _np(philox_randn(11, sh.local_shape, device="cpu", shard=runs)),
        }
        for name in ("gaussian", "pyramid"):
            fn, st = make_noise_sampler(get_noise_item(name), shape, device="cpu", seed=4,
                                        shard=sh)
            draws[what][name] = _np(fn(st, 5.0, 1.0)[0])
    out["draws"] = draws

    class UserNoise(NoiseItem):  # a user's own item: it does not say SHARDABLE
        def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
            return torch.zeros(ctx.shape), state

    out["refused"] = _raised(lambda: make_noise_sampler(
        UserNoise(), (4, 4, 16, 16), device="cpu", seed=4, shard=LatentShard.of(xs)))

    # scale_noise's global mode on a shard, and the dead-band of the global N
    for key in ("stats", "deadband"):
        v = torch.from_numpy(data[key])
        sh = LatentShard.of(shard_latent(v, mesh))
        out[key] = _np(scale_noise(shard_latent(v, mesh).to_local(), 1.5, shard=sh))
        out[key + "_local_n"] = _np(scale_noise(shard_latent(v, mesh).to_local(), 1.5))

    # SonarPipeline's doubled batch under dp, on injected noise
    def cond(x, s, **_):
        return x / (1.0 + s.reshape(-1, 1, 1, 1))

    def batched(x2, s2, **_):
        b = x2.shape[0] // 2
        return torch.cat([cond(x2[:b], s2[:b]),
                          (x2[b:] * 0.97) / (1.0 + s2[b:].reshape(-1, 1, 1, 1))], 0)

    pipe = SonarPipeline(model_batched=batched, cfg_scale=6.0, seed=5)
    got = pipe(xs, sig, noise_sampler=injected)
    out["cfg"] = (_np(got.to_local()), str(got.placements))
    return out


# -- tests/test_torch_dit_parallel.py ---------------------------------------------------------


def _dit(cfg_kw, state):
    from sonar_tpu_torch.models.dit import DiT, DiTConfig

    with torch.device("meta"):
        model = DiT(DiTConfig(**cfg_kw))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True,
                          assign=True)
    return model.eval()


@torch.no_grad()
def dit_world(data: dict) -> dict:
    """Every case of ``test_torch_dit_parallel.py`` in one 8-rank world: each
    case builds its mesh over the first ranks of the world; ranks outside a
    mesh skip its forward."""
    from sonar_tpu_torch.models import (dit_apply, dit_param_shardings, dit_pp_apply,
                                        make_dit_denoiser, pp_stage_params, shard_dit_params)
    from sonar_tpu_torch.parallel import make_mesh, shard_latent
    from sonar_tpu_torch.samplers.sonar import sample_sonar_euler_ancestral

    dense = _dit(data["dense_cfg"], data["dense"])
    moe = _dit(data["moe_cfg"], data["moe"])
    out: dict = {"rank": dist.get_rank()}
    mesh_of = {}

    def mesh(n, names, shape):
        key = (n, names, shape)
        if key not in mesh_of:
            mesh_of[key] = make_mesh(n, axis_names=names, mesh_shape=shape, device_type="cpu")
        return mesh_of[key]

    def case(name, m, fn):
        try:
            out[name] = fn(m) if m.get_coordinate() is not None else None
        except Exception:
            raise RuntimeError(f"case {name}:\n{traceback.format_exc()}") from None

    def forward(model, x, sig, m, *, tp=None, pp=None, ep=None, mb=None, dp="dp",
                aux=False):
        """The sharded forward of ``model`` on ``m``: x split on dp where the
        mesh has it, the module laid out by dit_param_shardings."""
        local = shard_dit_params(model, m, dit_param_shardings(model, m, tp=tp, pp=pp, ep=ep))
        xt = torch.from_numpy(x)
        xin = shard_latent(xt, m) if "dp" in m.mesh_dim_names else xt
        st = torch.from_numpy(sig)
        if pp:
            r = dit_pp_apply(local, xin, st, m, microbatches=mb, pp=pp, dp=dp, tp=tp,
                             return_aux=aux)
        else:
            r = dit_apply(local, xin, st, return_aux=aux)
        eps, a = r if aux else (r, None)
        first = 0
        if hasattr(eps, "to_local"):
            eps = eps.to_local()
            first = m.get_local_rank("dp") * eps.shape[0]
        return {"eps": _np(eps), "aux": None if a is None else float(a), "first": first}

    x4, s4, x8, s8 = data["x4"], data["s4"], data["x8"], data["s8"]
    case("pp2", mesh(2, ("pp",), (2,)), lambda m: forward(dense, x4, s4, m, pp="pp", mb=2))
    case("pp4", mesh(4, ("pp",), (4,)), lambda m: forward(dense, x4, s4, m, pp="pp", mb=2))
    case("pp2xdp2", mesh(4, ("dp", "pp"), (2, 2)),
         lambda m: forward(dense, x8, s8, m, pp="pp", mb=2))
    case("pp2xtp2", mesh(4, ("pp", "tp"), (2, 2)),
         lambda m: forward(dense, x4, s4, m, pp="pp", tp="tp", mb=2))
    case("tp2xdp2", mesh(4, ("dp", "tp"), (2, 2)), lambda m: forward(dense, x4, s4, m, tp="tp"))
    case("tp4xdp2", mesh(8, ("dp", "tp"), (2, 4)), lambda m: forward(dense, x4, s4, m, tp="tp"))
    case("ep2xdp2", mesh(4, ("dp", "ep"), (2, 2)),
         lambda m: forward(moe, x4, s4, m, ep="ep", aux=True))
    case("ep4xdp2", mesh(8, ("dp", "ep"), (2, 4)),
         lambda m: forward(moe, x4, s4, m, ep="ep", aux=True))
    case("ep2", mesh(2, ("ep",), (2,)), lambda m: forward(moe, x4, s4, m, ep="ep", aux=True))
    case("moe_pp2", mesh(2, ("pp",), (2,)),
         lambda m: forward(moe, x4, s4, m, pp="pp", mb=2, dp=None, aux=True))
    # the pipelined denoiser serving the sampler on dp x pp
    def serve(m):
        local = shard_dit_params(dense, m, dit_param_shardings(dense, m, tp=None, pp="pp"))
        den = make_dit_denoiser(local, pp_mesh=m, microbatches=1)
        xs = shard_latent(torch.from_numpy(data["x_serve"]), m)
        rows = xs.to_local().shape[0]
        first = m.get_local_rank("dp") * rows
        res = sample_sonar_euler_ancestral(
            den, xs, torch.from_numpy(_sigmas()),
            noise_sampler=lambda i, s, sn: torch.from_numpy(
                data["serve_noise"][i][first:first + rows]))
        return {"x": _np(res.to_local()), "first": first}
    case("serve_dp2xpp2", mesh(4, ("dp", "pp"), (2, 2)), serve)

    # the layouts, and the refusals
    sh = {}
    for key, model, names, shape, kw in (
            ("dense_tp", dense, ("dp", "tp"), (2, 4), dict(tp="tp")),
            ("dense_pp", dense, ("dp", "pp"), (2, 4), dict(tp=None, pp="pp")),
            ("dense_pp_tp", dense, ("pp", "tp"), (2, 4), dict(tp="tp", pp="pp")),
            ("moe_ep", moe, ("dp", "ep"), (2, 4), dict(tp=None, ep="ep")),
            ("moe_ep_tp", moe, ("ep", "tp"), (4, 2), dict(tp="tp", ep="ep"))):
        m = mesh(8, names, shape)
        sh[key] = {k: tuple(str(p) for p in v)
                   for k, v in dit_param_shardings(model, m, **kw).items()}
    out["shardings"] = sh
    ref = {}
    x2 = torch.zeros(2, 4, 16, 16)
    m = mesh(2, ("pp",), (2,))
    if m.get_coordinate() is not None:
        staged4 = pp_stage_params(dense, 4, 0)
        ref["stages"] = _raised(lambda: dit_pp_apply(staged4, x2, torch.ones(2), m,
                                                     microbatches=1, dp=None))
        ref["unstaged"] = _raised(lambda: dit_pp_apply(dense, x2, torch.ones(2), m,
                                                       microbatches=1, dp=None))
    ref["depth"] = _raised(lambda: pp_stage_params(dense, 3, 0))
    m = mesh(4, ("pp", "tp"), (2, 2))
    if m.get_coordinate() is not None:
        st = pp_stage_params(moe, 2, m.get_local_rank("pp"))
        ref["tp_moe"] = _raised(lambda: dit_pp_apply(st, torch.zeros(4, 4, 16, 16),
                                                     torch.ones(4), m, microbatches=2,
                                                     dp=None, tp="tp"))
    m = mesh(3, ("pp", "tp"), (1, 3))
    if m.get_coordinate() is not None:
        st = pp_stage_params(dense, 1, 0)
        ref["heads"] = _raised(lambda: dit_pp_apply(st, torch.zeros(4, 4, 16, 16),
                                                    torch.ones(4), m, microbatches=2,
                                                    dp=None, tp="tp"))
    m = mesh(8, ("dp", "pp"), (2, 4))
    st = pp_stage_params(dense, 4, m.get_local_rank("pp"))
    ref["microbatches"] = _raised(lambda: dit_pp_apply(
        st, shard_latent(torch.zeros(8, 4, 16, 16), m), torch.ones(8), m, microbatches=8))
    m = mesh(8, ("ep", "pp"), (4, 2))
    st = shard_dit_params(moe, m, dit_param_shardings(moe, m, tp=None, pp="pp", ep="ep"))
    ref["other_axis"] = _raised(lambda: dit_pp_apply(st, torch.zeros(4, 4, 16, 16),
                                                     torch.ones(4), m, microbatches=2, dp=None))
    out["refusals"] = ref
    return out


# -- tests/test_torch_parallel_train.py ---------------------------------------------------


def _unet(cfg_kw, state):
    from sonar_tpu_torch.models.unet import UNet, UNetConfig

    with torch.device("meta"):
        model = UNet(UNetConfig(**cfg_kw))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True,
                          assign=True)
    return model


def _grads(model) -> dict:
    return {k: _np(p.grad) for k, p in model.named_parameters()}


def _router_gaps(model) -> list:
    """The smallest gap between a token's two largest router probabilities,
    appended a forward of each MoE block of ``model``."""
    gaps: list = []
    for blk in model.blocks:
        blk.router.register_forward_hook(lambda mod, args, out: gaps.append(float(
            torch.softmax(out.detach().float(), -1).topk(2, -1).values.diff(dim=-1).abs().min())))
    return gaps


def _recording(draws: list):
    """``make_noise_sampler`` whose samplers append each draw to ``draws``."""
    import sonar_tpu_torch.samplers.sonar as S

    make = S.make_noise_sampler

    def recording(*a, **kw):
        fn, st = make(*a, **kw)

        def rec(state, sigma, sigma_next):
            noise, state = fn(state, sigma, sigma_next)
            draws.append(_np(noise))
            return noise, state
        return rec, st
    return recording


def parallel_train_world(data: dict) -> dict:
    """Every case of ``test_torch_parallel_train.py`` in one 4-rank world:
    the UNet's sharded steps on JAX's draws (each rank its rows), the MoE
    DiT's steps under dp and ep, the DiT's gradients through the pipeline
    (the MoE's under dp too), the sharded restores and a dp-sharded
    NoiseChain."""
    import functools

    from torch.distributed.tensor import DTensor, Replicate

    import sonar_tpu_torch.models.train as TR
    import sonar_tpu_torch.samplers.sonar as S
    from sonar_tpu_torch.models import (DiTConfig, dit_param_shardings, dit_pp_apply,
                                        init_train_state, make_train_step, restore_checkpoint,
                                        shard_dit_params)
    from sonar_tpu_torch.models.unet import UNet, UNetConfig
    from sonar_tpu_torch.noise import NoiseChain, get_noise_item
    from sonar_tpu_torch.noise.base import NoiseItem
    from sonar_tpu_torch.parallel import (LatentShard, make_mesh, shard_latent, shard_target,
                                          shard_unet_params, unet_param_shardings)
    from sonar_tpu_torch.parallel.grad import reduce_from
    from sonar_tpu_torch.parallel.mesh import all_reduce

    # a backward through an op with no autograd formula (a forward-only
    # collective) fails instead of passing its gradient on unchanged
    warnings.filterwarnings("error", message=".*an autograd kernel was not registered")
    out: dict = {"rank": dist.get_rank()}
    unet = _unet(data["unet_cfg"], data["unet"])
    ucfg = UNetConfig(**data["unet_cfg"])
    u, eps = torch.from_numpy(data["u"]), torch.from_numpy(data["eps"])

    def jax_draws(seed, batch, shard=None):
        """JAX's draws of the step, this rank's rows of them."""
        rows = slice(None) if shard is None else slice(
            shard.offset[0], shard.offset[0] + shard.local_shape[0])
        return u[rows], eps[rows]

    adam = functools.partial(torch.optim.Adam, lr=2e-3)
    batch = torch.from_numpy(data["batch"])
    meshes = {}

    def mesh(names, shape):
        if (names, shape) not in meshes:
            meshes[names, shape] = make_mesh(math.prod(shape), axis_names=names,
                                             mesh_shape=shape, device_type="cpu")
        return meshes[names, shape]

    def case(name, m, fn):
        try:
            out[name] = fn(m) if m.get_coordinate() is not None else None
        except Exception:
            raise RuntimeError(f"case {name}:\n{traceback.format_exc()}") from None

    TR_draws = TR.train_draws
    TR.train_draws = jax_draws
    try:
        def unet_step(m, fsdp):
            local = shard_unet_params(unet, m, fsdp=fsdp)
            before = {k: tuple(p.shape) for k, p in local.named_parameters()}
            opt = init_train_state(local, adam)
            loss = make_train_step(ucfg)(local, opt, shard_latent(batch, m), 3)
            return {"loss": float(loss), "grads": _grads(local), "coord": m.get_coordinate(),
                    "params": {k: _np(p) for k, p in local.named_parameters()},
                    "shapes": (before, {k: tuple(p.shape) for k, p in local.named_parameters()}),
                    "fsdp_params": sorted(local.fsdp_params),
                    "placements": {k: str(v) for k, v in unet_param_shardings(
                        unet, m, fsdp=fsdp).items()}}

        for key, shape, fsdp in (("dp2xtp2", (2, 2), False), ("fsdp_dp2xtp2", (2, 2), True),
                                 ("fsdp_dp4", (4, 1), True)):
            case(key, mesh(("dp", "tp"), shape), functools.partial(unet_step, fsdp=fsdp))

        # the refusal: FSDP on an axis the mesh lacks
        with torch.device("meta"):
            small = UNet(UNetConfig(**data["refusal_cfg"]))
        m = mesh(("data", "tp"), (4, 1))
        out["refusal"] = _raised(lambda: unet_param_shardings(small, m, fsdp=True))
        out["refusal_named"] = {k: str(v) for k, v in unet_param_shardings(
            small, m, fsdp=True, fsdp_axis="data").items()}
        # FSDP's gradient sums need the batch split on the FSDP axis
        local = shard_unet_params(unet, mesh(("dp", "tp"), (2, 2)), fsdp=True)
        out["refusal_batch"] = _raised(lambda: make_train_step(ucfg)(
            local, init_train_state(local, adam), batch, 3))

        # the sharded restores, and a step resumed on the FSDP layout
        m = mesh(("dp", "tp"), (2, 2))
        whole = {k: DTensor.from_local(p.detach(), m, (Replicate(), Replicate()),
                                       run_check=False) for k, p in unet.named_parameters()}
        got = restore_checkpoint(data["ckpt"], target={"params": whole}, partial=True)
        out["restore_replicated"] = {k: _np(v.to_local()) for k, v in got["params"].items()}
        out["restore_types"] = sorted({type(v).__name__ for v in got["params"].values()})
        local = shard_unet_params(unet, m, fsdp=True)
        shardings = unet_param_shardings(unet, m, fsdp=True)
        target = shard_target({k: p.detach() for k, p in local.named_parameters()}, m, shardings)
        order = [k for k, _ in local.named_parameters()]
        opt_target = {"state": {i: {"step": None, "exp_avg": target[k], "exp_avg_sq": target[k]}
                                for i, k in enumerate(order)}, "param_groups": None}
        got = restore_checkpoint(data["ckpt"], target={"params": target, "opt_state": opt_target},
                                 partial=True)
        out["restore_fsdp"] = {k: _np(v.to_local()) for k, v in got["params"].items()}
        out["restore_fsdp_moments"] = {
            order[i]: (_np(s["exp_avg"].to_local()), _np(s["exp_avg_sq"].to_local()))
            for i, s in got["opt_state"]["state"].items()}
        out["restore_coord"] = m.get_coordinate()
        with torch.no_grad():
            for k, p in local.named_parameters():
                p.copy_(got["params"][k].to_local())
        opt = init_train_state(local, adam)
        opt.load_state_dict({"state": {i: {kk: (v.to_local() if isinstance(v, DTensor) else v)
                                           for kk, v in s.items()}
                                       for i, s in got["opt_state"]["state"].items()},
                             "param_groups": got["opt_state"]["param_groups"]})
        out["resumed_loss"] = float(make_train_step(ucfg)(local, opt, shard_latent(batch, m), 4))
        out["resumed_grads"] = _grads(local)

        # the DiT's training step through the pipeline, pp=2 x tp=2
        def dit_step(m):
            model = _dit(data["dit_cfg"], data["dit"])
            plc = dit_param_shardings(model, m, tp="tp", pp="pp")
            local = shard_dit_params(model, m, plc)
            step = make_train_step(DiTConfig(**data["dit_cfg"]), pp_mesh=m, microbatches=2)
            loss = step(local, init_train_state(local, adam), batch, 3)
            return {"loss": float(loss), "grads": _grads(local),
                    "coord": dict(zip(m.mesh_dim_names, m.get_coordinate())),
                    "placements": {k: str(v) for k, v in plc.items()}}

        case("dit_step_pp2xtp2", mesh(("pp", "tp"), (2, 2)), dit_step)

        # the MoE DiT's training step with its batch split on dp (the routing
        # means summed over dp) and its experts split on ep
        def moe_step(m):
            model = _dit(data["moe_cfg"], data["moe"])
            plc = dit_param_shardings(model, m)
            local = shard_dit_params(model, m, plc)
            gaps = _router_gaps(local)
            step = make_train_step(DiTConfig(**data["moe_cfg"]), aux_weight=0.1)
            loss = step(local, init_train_state(local, adam), shard_latent(batch, m), 3)
            return {"loss": float(loss), "grads": _grads(local), "gap": min(gaps),
                    "coord": dict(zip(m.mesh_dim_names, m.get_coordinate())),
                    "placements": {k: str(v) for k, v in plc.items()}}

        for key, names, shape in (("moe_dp2", ("dp",), (2,)), ("moe_ep2", ("ep",), (2,)),
                                  ("moe_dp2xep2", ("dp", "ep"), (2, 2))):
            case(key, mesh(names, shape), moe_step)
        out["resumed_params"] = {k: _np(p.detach()) for k, p in local.named_parameters()}
    finally:
        TR.train_draws = TR_draws

    # the DiT's gradients through the pipeline: pp=2, and pp=2 x tp=2
    dense = _dit(data["dense_cfg"], data["dense"])
    x4, s4 = torch.from_numpy(data["x4"]), torch.from_numpy(data["s4"])

    def dit_grads(m, tp):
        local = shard_dit_params(dense, m, dit_param_shardings(dense, m, tp=tp, pp="pp"))
        loss = (dit_pp_apply(local, x4, s4, m, microbatches=2, dp=None, tp=tp) ** 2).sum()
        loss.backward()
        return {"loss": float(loss.detach()), "grads": _grads(local),
                "coord": dict(zip(m.mesh_dim_names, m.get_coordinate())),
                "placements": {k: str(v) for k, v in dit_param_shardings(
                    dense, m, tp=tp, pp="pp").items()}}

    case("dit_pp2", mesh(("pp",), (2,)), functools.partial(dit_grads, tp=None))
    case("dit_pp2xtp2", mesh(("pp", "tp"), (2, 2)), functools.partial(dit_grads, tp="tp"))

    # the MoE DiT's gradients through the pipeline under dp: each rank its
    # rows, the aux the mean over dp; the gradients then summed over dp
    moe = _dit(data["moe_cfg"], data["moe"])

    def moe_pp_grads(m):
        plc = dit_param_shardings(moe, m, pp="pp")
        local = shard_dit_params(moe, m, plc)
        gaps = _router_gaps(local)
        b = x4.shape[0] // m.size(m.mesh_dim_names.index("dp"))
        rows = slice(m.get_local_rank("dp") * b, (m.get_local_rank("dp") + 1) * b)
        eps, aux = dit_pp_apply(local, x4[rows], s4[rows], m, microbatches=2, dp="dp",
                                return_aux=True)
        loss = reduce_from((eps**2).sum(), m, "dp") / x4.numel() + aux
        loss.backward()
        for p in local.parameters():
            p.grad = all_reduce(p.grad, m.get_group("dp"))
        return {"loss": float(loss.detach()), "grads": _grads(local), "gap": min(gaps),
                "coord": dict(zip(m.mesh_dim_names, m.get_coordinate())),
                "placements": {k: str(v) for k, v in plc.items()}}

    case("moe_pp2xdp2", mesh(("dp", "pp"), (2, 2)), moe_pp_grads)

    # NoiseChain([gaussian, pyramid]) under dp=4
    m = mesh(("dp",), (4,))
    xs = shard_latent(torch.from_numpy(data["x_chain"]), m)
    draws: list = []
    S_make = S.make_noise_sampler
    S.make_noise_sampler = _recording(draws)
    try:
        res = S.sample_sonar_euler_ancestral(
            _stub(data["target"][dist.get_rank():dist.get_rank() + 1]), xs,
            torch.from_numpy(_sigmas()),
            noise_item=NoiseChain([get_noise_item("gaussian"), get_noise_item("pyramid")]),
            seed=0)
    finally:
        S.make_noise_sampler = S_make
    out["chain"] = {"x": _np(res.to_local()), "draws": draws, "placements": str(res.placements)}

    class UserNoise(NoiseItem):  # a user's own item: it does not say SHARDABLE
        def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
            return torch.zeros(ctx.shape), state

    out["chain_refused"] = _raised(lambda: S.make_noise_sampler(
        NoiseChain([get_noise_item("gaussian"), UserNoise()]), tuple(xs.shape),
        device="cpu", seed=0, shard=LatentShard.of(xs)))
    return out


# -- tests/test_torch_parallel_samplers.py ------------------------------------------------


SAMPLER_SHAPE = (4, 4, 16, 16)
# the SDE samplers, whose default noise is Brownian
SDE_NAMES = ("sonar_dpmpp_sde", "dpmpp_sde", "dpmpp_sde_gpu", "dpmpp_2m_sde",
             "dpmpp_2m_sde_gpu", "dpmpp_3m_sde", "dpmpp_3m_sde_gpu")


def sampler_sigmas():
    """A Karras-style schedule 14.6 → 0.03 of six steps and a final 0."""
    ramp = np.linspace(0, 1, 6)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return np.concatenate([s, [0.0]]).astype(np.float32)


def takes_noise_sampler(fn) -> bool:
    import inspect

    return "noise_sampler" in inspect.signature(fn).parameters


def restart_table(k: int, shape) -> np.ndarray:
    """The k-th restart jump's normals (the parent hands JAX the same)."""
    return np.random.default_rng([7, k]).standard_normal(tuple(shape)).astype(np.float32)


def _counting(fn, calls: list):
    def den(x, s, **kw):
        calls.append(1)
        return fn(x, s, **kw)

    return den


def guided_cases(device="cpu"):
    """The JAX package's dryrun paths (``__graft_entry__.py:259-366``) on the
    port, at CPU size: name → (pipeline, x0, sigmas). The same seeds build
    the same weights in the parent and in every rank."""
    from sonar_tpu_torch.api import SonarPipeline
    from sonar_tpu_torch.api.guider import make_latent_op_cfg_function
    from sonar_tpu_torch.cfg import (DiscreteSampling, FreeUExtremeConfig, Flow, WaveletCFG,
                                     WCFGRules, make_freeu_patches)
    from sonar_tpu_torch.models import make_dit_denoiser
    from sonar_tpu_torch.models.dit import DiTConfig, init_dit_params
    from sonar_tpu_torch.models.unet import UNetConfig, init_unet_params, make_denoiser
    from sonar_tpu_torch.noise import get_noise_item
    from sonar_tpu_torch.noise.power import PowerFilter

    ucfg = UNetConfig(model_channels=16, channel_mult=(1, 2), attention_levels=(1,),
                      num_heads=2, norm_groups=4)
    unet = init_unet_params(torch.Generator().manual_seed(0), ucfg, device=device)
    ms = DiscreteSampling()
    frux = FreeUExtremeConfig(target="backbone", stage_1=True, scale=1.1, hidden_mean=True,
                              sonar_power_filter=PowerFilter(max_freq=0.3))
    patches = make_freeu_patches(model_sampling=ms, model_channels=16, output_config=frux)
    model = make_denoiser(unet)
    rules = WCFGRules.build(wave="db4", level=2, padding_mode="periodization",
                            high_precision_mode=False,
                            diff=dict(yl_scale=6.0, yh_scales=[5.0, "fill"]))
    lo_cfg = make_latent_op_cfg_function(
        operations=(lambda latent=None, **kw: latent * 1.05,), mode="denoised",
        blend_scale_mode="reverse_sampling", blend_strength=0.5, model_sampling=ms)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(SAMPLER_SHAPE)
                          .astype(np.float32) * 14.6).to(device)
    sig = sampler_sigmas()
    cases = {
        "wcfg_freeu_latent_op": SonarPipeline(
            model=make_denoiser(unet, block_patches=patches), model_uncond=model,
            sampler="sonar_euler", cfg_scale=6.0, wavelet_cfg=WaveletCFG(rules=rules),
            latent_op_cfg=lo_cfg, model_sampling=ms, seed=11),
        "dpmpp_2s_ancestral_pyramid": SonarPipeline(
            model=model, sampler="dpmpp_2s_ancestral", cfg_scale=1.0, model_sampling=ms,
            seed=19, noise=get_noise_item("pyramid")),
        "uni_pc": SonarPipeline(model=model, sampler="uni_pc", cfg_scale=1.0,
                                model_sampling=ms, seed=19),
    }
    out = {k: (p, x0, sig) for k, p in cases.items()}
    fms = Flow(shift=3.0)
    dit = init_dit_params(torch.Generator().manual_seed(12),
                          DiTConfig(hidden=32, depth=2, num_heads=4, patch_size=2), device=device)
    fden = make_dit_denoiser(dit, prediction="flow", timestep_fn=fms.timestep)
    fx = torch.from_numpy(np.random.default_rng(5).standard_normal(SAMPLER_SHAPE)
                          .astype(np.float32)).to(device)
    out["flow_dit"] = (SonarPipeline(model=fden, model_sampling=fms, seed=17), fx,
                       np.asarray([1.0, 0.75, 0.5, 0.25, 0.0], np.float32))
    return out


@torch.no_grad()
def parallel_samplers_world(data: dict) -> dict:
    """Every case of ``test_torch_parallel_samplers.py`` in one 4-rank world:
    the 31 registry names on a dp-sharded latent on injected noise, the SDE
    names on their default Brownian noise, and the guided paths."""
    import sonar_tpu_torch.samplers.restart as restart
    from sonar_tpu_torch.api.functions import SAMPLERS
    from sonar_tpu_torch.parallel import LatentShard, make_mesh, shard_latent

    mesh = make_mesh(axis_names=("dp",), device_type="cpu")
    xs = shard_latent(torch.from_numpy(data["x0"]), mesh)
    sh = LatentShard.of(xs)
    rows = slice(sh.offset[0], sh.offset[0] + sh.local_shape[0])
    model = _stub(data["target"][rows])
    sig = torch.from_numpy(sampler_sigmas())
    injected = lambda i, s, sn: torch.from_numpy(data["noises"][i][rows])  # noqa: E731
    # restart's jumps: this rank's rows of the k-th table draw of the whole latent
    jumps = []

    def table_randn(seed, shape, *, device, dtype=torch.float32, stream=0, shard=None):
        full = restart_table(len(jumps), SAMPLER_SHAPE)
        jumps.append(tuple(shape))
        return torch.from_numpy(full[rows]).to(device=device, dtype=dtype)

    out: dict = {"rank": dist.get_rank(), "box": (sh.offset, sh.local_shape)}
    real_randn = restart.philox_randn
    restart.philox_randn = table_randn
    try:
        for name, fn in sorted(SAMPLERS.items()):
            calls = []
            kw = {"noise_sampler": injected} if takes_noise_sampler(fn) else {}
            res = fn(_counting(model, calls), xs, sig, seed=3, **kw)
            out[name] = (_np(res.to_local()), str(res.placements), len(calls))
    finally:
        restart.philox_randn = real_randn
    out["restart_jumps"] = len(jumps)
    for name in SDE_NAMES:
        out["brownian " + name] = _np(SAMPLERS[name](model, xs, sig, seed=3).to_local())
    for name, (pipe, x0, s) in guided_cases().items():
        res = pipe(shard_latent(x0, mesh), torch.from_numpy(s))
        out["guided " + name] = (_np(res.to_local()), str(res.placements))
    return out


# -- tests/test_torch_parallel_noise.py ---------------------------------------------------


# the layouts of test_torch_parallel.py's test_sharded_draws_are_slices
NOISE_LAYOUTS = {"dp": (4, 4, 16, 16), "dp ragged": (4, 3, 5, 7), "sp": (1, 4, 8, 16, 16)}
NOISE_SIGMAS = ((5.0, 1.0), (1.0, 0.5))  # two draws: the second reads the first's state


def combinator_trees() -> dict:
    """A few combinator trees: name → (item, layout). Among them the items
    that couple along the split axis (ShuffledNoise, PerDimNoise on it)."""
    from sonar_tpu_torch.noise import get_noise_item
    from sonar_tpu_torch.noise.combinators import (
        BlendedNoise, ChannelNoise, CustomNoiseParametersNoise, GuidedNoise, ModulatedNoise,
        NormalizeToScaleNoise, PerDimNoise, QuantileFilteredNoise, RepeatedNoise,
        RippleFilteredNoise, ShuffledNoise)
    from sonar_tpu_torch.noise.voronoi import VoronoiGenerator

    g, py = get_noise_item("gaussian"), get_noise_item("pyramid")
    zwalk = VoronoiGenerator(n_points=(16,), z_increment=0.35, z_range=10.0, result_mode=("f1",))
    return {
        "shuffled batch": (ShuffledNoise(noise=g, dims=(0, -1)), "dp"),
        "shuffled width": (ShuffledNoise(noise=py, dims=(-1,), percentages=(0.5,)), "dp"),
        "perdim batch": (PerDimNoise(noise=get_noise_item("brownian"), dim=0), "dp"),
        "perdim channel": (PerDimNoise(noise=g, dim=1), "dp"),
        "perdim frames z-walk": (PerDimNoise(
            noise=CustomNoiseParametersNoise(noise=zwalk, frames_to_channels=True,
                                             normalize=False),
            dim=2, chunk_size=1, normalize=False), "sp"),
        "channel": (ChannelNoise(noise=[g, get_noise_item("uniform")]), "dp"),
        "repeated": (RepeatedNoise(noise=g, repeat_length=1, permute="always"), "dp"),
        "modulated": (ModulatedNoise(noise=g, modulation_type="intensity"), "dp"),
        "guided": (GuidedNoise(ref_latent=np.linspace(-1, 1, 4 * 4 * 16 * 16, dtype=np.float32)
                               .reshape(4, 4, 16, 16), noise=g), "dp"),
        "normalize_to_scale": (NormalizeToScaleNoise(noise=g), "dp"),
        "quantile": (QuantileFilteredNoise(noise=g, norm_dim=None), "dp"),
        "ripple batch": (RippleFilteredNoise(noise=g, dim=0, roll=1.0), "dp"),
        "blended mask sp": (BlendedNoise(custom_noise_1=g, custom_noise_2=py,
                                         custom_noise_mask=get_noise_item("uniform")), "sp"),
    }


def video_item():
    """Config 5's video noise (``tools/bench_configs.py:105-140``):
    time-Brownian power noise with the frames folded into the channels."""
    from sonar_tpu_torch.noise import CustomNoiseParametersNoise
    from sonar_tpu_torch.noise.power import PowerNoiseItem

    return CustomNoiseParametersNoise(
        noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
        frames_to_channels=True)


VIDEO_SHAPE = (1, 4, 16, 16, 16)
SWEEP_SHAPE = (1, 4, 4, 8, 8)


def noise_nodes():
    """Every node of the port's node API that builds a noise item, built with
    its link inputs at CPU tensors (``tests/test_schema_validation.py``'s
    link factories): name → item, or None where the builder needs more."""
    from sonar_tpu_torch.api.nodes import NODES, build
    from sonar_tpu_torch.api.schemas import SCHEMAS
    from sonar_tpu_torch.api.validate import ALIASES
    from sonar_tpu_torch.cfg.latent_ops import SonarLatentOperation
    from sonar_tpu_torch.cfg.model_sampling import ContinuousEDM
    from sonar_tpu_torch.noise import NoiseChain, get_noise_item
    from sonar_tpu_torch.noise.base import NoiseItem
    from sonar_tpu_torch.noise.power import PowerFilter

    links = {
        "OCS_NOISE,SONAR_CUSTOM_NOISE": lambda: NoiseChain([get_noise_item("gaussian")]),
        "SONAR_POWER_FILTER": PowerFilter,
        "LATENT": lambda: torch.zeros((1, 4, 8, 8)),
        "MASK": lambda: torch.ones((8, 8)),
        "IMAGE": lambda: torch.zeros((8, 8, 3)),
        "SIGMAS": lambda: torch.tensor([14.6, 7.0, 0.0]),
        "LATENT_OPERATION": lambda: SonarLatentOperation(),
        "SAMPLER": lambda: "sonar_euler",
    }
    overrides = {
        "SonarScheduledNoise": {"model": ..., "model_sampling": ContinuousEDM()},
        "SonarWaveletCFG": {"model": ...},
        "FreeUExtreme": {"model": ..., "model_sampling": ContinuousEDM(),
                         "model_channels": 320},
        "NoisyLatentLike": {"model_sampling": ContinuousEDM()},
    }
    out = {}
    for name in sorted(n for n in SCHEMAS if n in NODES or n in ALIASES.values()):
        schema = SCHEMAS[ALIASES.get(name, name)]
        extra = overrides.get(name, {})
        kw = {f: links[s["ty"]]() for f, s in schema.items()
              if f not in extra and s["t"] == "x" and s["ty"] in links}
        kw.update({f: v for f, v in extra.items() if v is not ...})
        try:
            obj = build(name, **kw)
        except Exception:
            continue  # a node that needs richer inputs; the node tests cover it
        if isinstance(obj, NoiseItem):
            out[name] = obj
    return out


def _draws(item, shape, shard=None, normalized=True):
    from sonar_tpu_torch.noise import make_noise_sampler

    fn, st = make_noise_sampler(item, shape, device="cpu", seed=4, sigma_min=0.03,
                                sigma_max=14.6, shard=shard, normalized=normalized)
    got = []
    for s, sn in NOISE_SIGMAS:
        n, st = fn(st, s, sn)
        got.append(_np(n))
    return got


@torch.no_grad()
def parallel_noise_world(data: dict) -> dict:
    """Every case of ``test_torch_parallel_noise.py`` in one 4-rank world:
    every noise name and a few combinator trees drawn on the three layouts,
    config 5's video noise on sp, the node sweep on sp, B5's plain version
    with ``planes=``, the refusal, and the 1-rank collective."""
    import sonar_tpu_torch.parallel.mesh as pmesh
    from sonar_tpu_torch.kernels.fused_pyramid import fused_downscale_pyramid
    from sonar_tpu_torch.noise import NoiseChain, get_noise_item, make_noise_sampler
    from sonar_tpu_torch.noise.base import NoiseItem
    from sonar_tpu_torch.noise.presets import noise_type_names
    from sonar_tpu_torch.parallel import LatentShard, make_mesh, shard_latent

    meshes = {"dp": make_mesh(axis_names=("dp",), device_type="cpu"),
              "sp": make_mesh(axis_names=("dp", "sp"), mesh_shape=(1, 4), device_type="cpu")}

    def shard_of(shape):
        sp = "sp" if len(shape) == 5 else None
        return LatentShard.of(shard_latent(torch.zeros(shape), meshes["sp" if sp else "dp"],
                                           sp=sp))

    out: dict = {"rank": dist.get_rank(), "boxes": {}}
    for layout, shape in NOISE_LAYOUTS.items():
        sh = shard_of(shape)
        out["boxes"][layout] = (sh.offset, sh.local_shape)
        for name in noise_type_names():
            for normalized in (True, False):
                out[("name", layout, name, normalized)] = _try(
                    lambda: _draws(get_noise_item(name), shape, sh, normalized))
    for tree, (item, layout) in combinator_trees().items():
        out[("tree", tree)] = _try(lambda: _draws(item, NOISE_LAYOUTS[layout],
                                                  shard_of(NOISE_LAYOUTS[layout])))
    vsh = shard_of(VIDEO_SHAPE)
    out["boxes"]["video"] = (vsh.offset, vsh.local_shape)
    out["video"] = _draws(video_item(), VIDEO_SHAPE, vsh)
    wsh = shard_of(SWEEP_SHAPE)
    out["boxes"]["sweep"] = (wsh.offset, wsh.local_shape)
    out["sweep"] = {name: _try(lambda: _draws(item, SWEEP_SHAPE, wsh)[:1])
                    for name, item in noise_nodes().items()}
    # B5's plain version with planes=, on each layout's planes
    b5 = {}
    for layout, shape in NOISE_LAYOUTS.items():
        sh = shard_of(shape)
        bc = math.prod(sh.local_shape[:-2])
        h, w = shape[-2:]
        for mode, sizes, coefs in (("bilinear", [(h, w), (3 * h, 3 * w)], [1.0, 0.7]),
                                   ("nearest-exact", [(2 * h, 2 * w), (4 * h, 4 * w)],
                                    [1.0, 0.4])):
            b5[(layout, mode)] = _np(fused_downscale_pyramid(
                9, (1, bc, h, w), sizes, coefs, mode, device="cpu", planes=sh.plane_runs()))
    out["b5"] = b5

    # the refusal: an item that does not say SHARDABLE, alone and in a chain
    class Plain(NoiseItem):
        def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
            return torch.zeros(ctx.shape), state

    dp_shard = shard_of(NOISE_LAYOUTS["dp"])
    out["refused"] = [
        _raised(lambda: make_noise_sampler(it, NOISE_LAYOUTS["dp"], device="cpu",
                                           shard=dp_shard))
        for it in (Plain(), NoiseChain([get_noise_item("gaussian"), Plain()]))]

    # the 1-rank collective: a sum over a 1-rank group makes no dist call
    calls = []
    real = dist.all_reduce

    def counted(t, *a, **kw):
        calls.append(1)
        return real(t, *a, **kw)

    one = make_mesh(axis_names=("dp", "tp"), mesh_shape=(4, 1), device_type="cpu")
    pmesh.dist.all_reduce = counted
    try:
        t = torch.arange(3.0) + dist.get_rank()
        tp_sum = pmesh.psum(t, one, "tp")
        n_tp = len(calls)
        dp_sum = pmesh.psum(t, one, "dp")
        out["one_rank"] = (n_tp, len(calls) - n_tp, _np(tp_sum), _np(dp_sum),
                           _np(pmesh.all_max(t, one.get_group("dp"))),
                           _np(pmesh.all_min(t, one.get_group("dp"))))
    finally:
        pmesh.dist.all_reduce = real
    return out


def _try(fn):
    """``fn()``, or ("raised", exception type, message)."""
    try:
        return fn()
    except Exception as e:  # the test holds refusals by type
        return ("raised", type(e).__name__, str(e)[:300])
