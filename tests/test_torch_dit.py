"""The port's DiT against the JAX DiT: the same parameters (mapped by
``dit_params_from_jax``) and the same numpy inputs through both.

Tolerances, relative to max(1, |JAX|): 1e-5 for the float32 forward and the
denoisers (products sum in another order in XLA and PyTorch on the CPU); two
bf16 ulps (2⁻⁶) for the bf16 forward, both sides rounding each layer to
bf16; 1e-4 for sampler trajectories.

Switch routing takes an ``argmax`` of the router's softmax: a near-tie could
route a token to another expert when the two sides' logits differ by an ulp.
The MoE comparisons therefore state a precondition at their fixed seeds:
every token's top two router probabilities are at least ``MARGIN`` apart,
far above the ~1e-6 by which the two sides' logits differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.models.dit as jd
import sonar_tpu.samplers.sonar as js
import sonar_tpu_torch.models.dit as td
import sonar_tpu_torch.samplers.sonar as ts
from sonar_tpu.cfg import Flow as JFlow
from sonar_tpu_torch.cfg import Flow as TFlow

REL = 1e-5
BF16_REL = 2.0**-6
MARGIN = 1e-4
DENSE = dict(hidden=64, depth=3, num_heads=4)
MOE = dict(hidden=64, depth=2, num_heads=4, num_experts=4, capacity_factor=1.0)


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


def _randomized(params, seed=0):
    """Every leaf of the JAX init's tree (shapes only: ``jax.eval_shape``
    draws nothing) drawn with numpy at full scale (the JAX init zeroes
    biases and shrinks adaLN and output weights, which would hide mapping
    errors)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        fan_in = a.shape[-2] if a.ndim >= 2 else 1
        scale = 1.0 / np.sqrt(fan_in) if a.ndim >= 2 else 0.1
        return np.asarray(rng.standard_normal(a.shape) * scale, np.float32)

    return jax.tree.map(draw, params)


def _pair(cfg_kw, seed=0, dtype=None):
    """(JAX params, JAX config, port module) with the same randomized weights."""
    jcfg = jd.DiTConfig(**cfg_kw, **({"dtype": jnp.bfloat16} if dtype else {}))
    params = _randomized(jax.eval_shape(
        lambda k: jd.init_dit_params(k, jd.DiTConfig(**cfg_kw)), jax.random.key(seed)), seed)
    with torch.device("meta"):
        model = td.DiT(td.DiTConfig(**cfg_kw, **({"dtype": dtype} if dtype else {})))
    model.load_state_dict(td.dit_params_from_jax(params), strict=True, assign=True)
    if dtype:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
        model = model.to(dtype)
    return params, jcfg, model.eval()


def _inputs(shape=(2, 4, 16, 16), seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    sigma = np.linspace(0.3, 9.0, shape[0]).astype(np.float32)
    return x, sigma


def _router_margin(model, x, sigma):
    """The smallest gap between a token's top two router probabilities, over
    every block (the routing precondition)."""
    gaps = []

    def hook(_, __, logits):
        top2 = torch.softmax(logits.float(), -1).topk(2, dim=-1).values
        gaps.append(float((top2[..., 0] - top2[..., 1]).min()))

    handles = [blk.router.register_forward_hook(hook) for blk in model.blocks]
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(sigma))
    for h in handles:
        h.remove()
    return min(gaps)


@pytest.mark.parametrize("cfg_kw", [DENSE, MOE, dict(DENSE, hidden=66, num_heads=3)],
                         ids=["dense", "moe", "hidden66"])
def test_forward_matches_jax(cfg_kw):
    """Dense, MoE, and a width that is not a multiple of 4 (the position
    table's zero pad); the MoE load-balance loss too."""
    params, jcfg, model = _pair(cfg_kw)
    x, sigma = _inputs()
    if cfg_kw.get("num_experts"):
        assert _router_margin(model, x, sigma) >= MARGIN  # precondition
    ref, ref_aux = jax.jit(lambda p, a, s: jd.dit_apply(p, a, s, jcfg, return_aux=True))(
        params, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        out, aux = td.dit_apply(model, torch.from_numpy(x), torch.from_numpy(sigma),
                                return_aux=True)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    _close_rel(out.numpy(), ref)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * max(1.0, abs(float(ref_aux)))
    if cfg_kw.get("num_experts"):
        assert float(aux) >= 1.0 - 1e-6


@pytest.mark.parametrize("cfg_kw", [DENSE, MOE], ids=["dense", "moe"])
def test_bf16_forward_matches_jax(cfg_kw):
    """bf16 compute: float32 output (the latent's dtype), float32 attention
    logits, and the JAX bf16 forward within two bf16 ulps."""
    params, jcfg, model = _pair(cfg_kw, seed=2, dtype=torch.bfloat16)
    x, sigma = _inputs(seed=3)
    ref = jax.jit(lambda p, a, s: jd.dit_apply(p, a, s, jcfg))(
        params, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(sigma))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    _close_rel(out.numpy(), np.asarray(ref, np.float32), BF16_REL)


def test_pieces_match_jax():
    """Position table (hidden 64 and 66), patch layout, layer norm."""
    for d in (64, 66):
        ref = jd._pos_embed(5, 7, d, jnp.float32)
        out = td._pos_embed(5, 7, d, torch.float32, torch.device("cpu"))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    x = np.random.default_rng(4).standard_normal((2, 3, 8, 12)).astype(np.float32)
    tok, hp, wp = jd._patchify(jnp.asarray(x), 2)
    ttok, thp, twp = td._patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    assert (thp, twp) == (hp, wp) == (4, 6)
    np.testing.assert_array_equal(td._unpatchify(ttok, 4, 6, 2, 3).numpy(), x)
    h = np.random.default_rng(5).standard_normal((2, 9, 64)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(td._layer_norm(torch.from_numpy(h)).numpy(),
                               np.asarray(jd._layer_norm(jnp.asarray(h))), rtol=0, atol=2e-6)


def _moe_block(d, e, f, seed):
    rng = np.random.default_rng(seed)
    blk = td.Block(td.DiTConfig(hidden=d, num_heads=1, mlp_ratio=f // d, num_experts=e,
                                capacity_factor=4.0))
    with torch.no_grad():
        blk.router.weight.copy_(torch.from_numpy(rng.standard_normal((e, d)) * 0.5))
        blk.router.bias.zero_()
        for lin, shape in ((blk.mlp_in, (e, d, f)), (blk.mlp_out, (e, f, d))):
            lin.weight.copy_(torch.from_numpy(rng.standard_normal(shape) * 0.2))
            lin.bias.zero_()
    return blk


def test_moe_matches_per_token_routing():
    """The einsum dispatch/combine equals per-token gather routing when the
    capacity is large enough that nothing drops (tests/test_dit.py's check
    on the port)."""
    blk = _moe_block(16, 4, 32, seed=5)
    xt = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 6, 16)).astype(np.float32))
    with torch.no_grad():
        got, _ = blk.moe_mlp(xt)
        probs = torch.softmax(blk.router(xt).float(), -1)
        idx, gate = probs.argmax(-1), probs.amax(-1)
        want = torch.zeros_like(xt)
        for b in range(2):
            for t in range(6):
                e = int(idx[b, t])
                hmid = td._gelu(xt[b, t] @ blk.mlp_in.weight[e] + blk.mlp_in.bias[e])
                want[b, t] = gate[b, t] * (hmid @ blk.mlp_out.weight[e] + blk.mlp_out.bias[e])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    assert len(set(idx.flatten().tolist())) > 1  # several experts are used


def test_moe_capacity_drops_tokens():
    """Tokens past an expert's capacity contribute nothing (residual only)."""
    blk = td.Block(td.DiTConfig(hidden=8, num_heads=1, mlp_ratio=1, num_experts=2,
                                capacity_factor=1e-9))  # C = 1
    with torch.no_grad():
        blk.router.weight.zero_()
        blk.router.bias.copy_(torch.tensor([5.0, -5.0]))  # every token to expert 0
        for lin in (blk.mlp_in, blk.mlp_out):
            lin.weight.fill_(0.1)
            lin.bias.zero_()
        y, _ = blk.moe_mlp(torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(6)))
    assert not torch.allclose(y[0, 0], torch.zeros(8))
    assert torch.equal(y[0, 1:], torch.zeros(3, 8))


@pytest.mark.parametrize("prediction", ["eps", "v", "x0", "flow"])
def test_denoiser_matches_jax(prediction):
    params, jcfg, model = _pair(DENSE, seed=3)
    x, _ = _inputs(seed=7)
    flow = prediction == "flow"
    sigma = np.float32(0.6 if flow else 2.5)
    ref = jd.make_dit_denoiser(params, jcfg, prediction=prediction,
                               timestep_fn=JFlow().timestep if flow else None)(
        jnp.asarray(x), jnp.asarray(sigma))
    den = td.make_dit_denoiser(model, prediction=prediction,
                               timestep_fn=TFlow().timestep if flow else None)
    out = den(torch.from_numpy(x), torch.tensor(sigma))
    _close_rel(out.numpy(), ref)
    # weights as a call-time argument: zeroed weights change the output
    zeroed = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    assert not torch.allclose(den(torch.from_numpy(x), torch.tensor(sigma), params=zeroed), out)


def test_sampler_trajectory_matches_jax():
    """The slice as a whole: sample_sonar_euler_ancestral over the DiT on one
    injected numpy noise stream, 6 bench-schedule steps."""
    params, jcfg, model = _pair(DENSE, seed=4)
    ramp = np.linspace(0, 1, 6)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    sig = np.concatenate([s, [0.0]]).astype(np.float32)
    shape = (1, 4, 16, 16)
    rng = np.random.default_rng(8)
    x0 = rng.standard_normal(shape).astype(np.float32) * sig[0]
    noises = [rng.standard_normal(shape).astype(np.float32) for _ in range(6)]
    stacked = jnp.asarray(np.stack(noises))
    ref = jax.jit(lambda x: js.sample_sonar_euler_ancestral(
        jd.make_dit_denoiser(params, jcfg), x, jnp.asarray(sig),
        noise_sampler=lambda i, a, b: stacked[i]))(jnp.asarray(x0))
    out = ts.sample_sonar_euler_ancestral(
        td.make_dit_denoiser(model), torch.from_numpy(x0), torch.from_numpy(sig),
        noise_sampler=lambda i, a, b: torch.from_numpy(noises[i]))
    _close_rel(out.numpy(), ref, 1e-4)


def test_dit_drives_the_pipeline():
    """The DiT denoiser through SonarPipeline (tests/test_dit.py's check on
    the port): finite, the latent's shape, reproducible for one seed."""
    from sonar_tpu_torch.api import SonarPipeline

    model = td.init_dit_params(torch.Generator().manual_seed(0),
                               td.DiTConfig(hidden=64, depth=2, num_heads=4), device="cpu")
    pipe = SonarPipeline(model=td.make_dit_denoiser(model), sampler="sonar_euler_ancestral",
                         seed=0)
    sig = torch.from_numpy(np.concatenate([np.geomspace(14.6, 0.03, 6), [0.0]]).astype(np.float32))
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, 16, 16))
                          .astype(np.float32)) * 14.6
    out = pipe(x0, sig)
    assert out.shape == x0.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out, pipe(x0, sig))


def test_init_dit_params():
    """The JAX init's scales: std scale/sqrt(din) (adaLN, attn_out, mlp_out,
    router and the head 1e-2), zero biases; float32 or bf16 as configured."""
    cfg = td.DiTConfig(hidden=64, depth=2, num_heads=4, num_experts=2)
    model = td.init_dit_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sd = model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert all(not v.any() for k, v in sd.items() if k.endswith("bias"))
    for name, din, scale in (("blocks.0.qkv.weight", 64, 1.0), ("blocks.1.ada.weight", 64, 1e-2),
                             ("blocks.0.mlp_in.weight", 64, 1.0),
                             ("blocks.0.mlp_out.weight", 256, 1e-2),
                             ("patch_embed.weight", 16, 1.0)):
        std = float(sd[name].std())
        assert abs(std / (scale / np.sqrt(din)) - 1.0) < 0.1, (name, std)
    assert sd["blocks.0.mlp_in.weight"].shape == (2, 64, 256)
    bf = td.init_dit_params(torch.Generator().manual_seed(0),
                            td.DiTConfig(hidden=64, depth=1, num_heads=4, dtype=torch.bfloat16),
                            device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
