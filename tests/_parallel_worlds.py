"""What the ranks of the parallel tests' gloo worlds run (spawned by
``sonar_tpu_torch.parallel.run_world``; the test files compare the results
with the JAX package's unsharded functions in the parent process).

Each world function takes plain numpy inputs, runs every case of its file in
one world and returns, per rank, a dict of numpy results keyed by case. It
imports the port and torch only: the spawned ranks never load JAX.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().numpy()


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
    out["refused"] = _raised(lambda: make_noise_sampler(
        get_noise_item("perlin"), (4, 4, 16, 16), device="cpu", seed=4,
        shard=LatentShard.of(xs)))

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
