"""FLUX.1 in the port (``sonar_tpu_torch/models/flux.py``) on the CPU, at a
small size (hidden 96, 3 heads of 32, RoPE axes (8, 12, 12), 2 double and 2
single blocks, an 8×8 latent of 4 channels, 8 text tokens).

- The module equals the plain reference (``benchmark/reference/flux.py``,
  written from BFL's code with none of the port's) on the same weights, in
  float32 and bf16.
- RoPE turns one pair of a head by ``pos·θ^(−2j/a)`` at known positions;
  the q/k norm is an RMS norm times the learned scale.
- The joint sequence is ``cat(txt, img)`` and the attention's output is
  split back at the text length.
- Patchify is ``b c (h 2) (w 2) -> b (h w) (c 2 2)`` and unpatchify undoes it.
- ``make_flux_denoiser`` runs through ``SonarPipeline`` with ``Flow``, the
  network seeing σ and the rectified-flow split, as the reference sampler
  does.
- The FLOP count against ``FlopCounterMode``.

The JAX package has no FLUX model, so nothing here is held against JAX.
"""

import math
import pathlib
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import sonar_tpu_torch.models.flux as FX
from sonar_tpu_torch.models import Flux, FluxConfig, flux_forward_flops, make_flux_denoiser

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import weights  # noqa: E402
from benchmark.families import _common  # noqa: E402
from benchmark.reference import flux as R  # noqa: E402

SMALL = dict(in_channels=16, out_channels=16, vec_in_dim=32, context_in_dim=48,
             hidden_size=96, mlp_ratio=4, num_heads=3, depth=2, depth_single_blocks=2,
             axes_dim=[8, 12, 12], theta=10000, context_tokens=8, guidance=3.5)


def _cfg(dtype=torch.float32):
    return FluxConfig(**{k: (tuple(v) if k == "axes_dim" else v) for k, v in SMALL.items()
                         if k not in ("context_tokens", "guidance")}, dtype=dtype)


def _model(seed=3, dtype=torch.float32):
    """The port's module on the reference's weights: ``(module, params)``,
    ``params`` holding the prompt's encodings too."""
    params = weights.make(R.param_specs(SMALL), seed, "cpu")
    net = {k: v for k, v in params.items() if not k.startswith("cond.")}
    with torch.device("meta"):
        module = Flux(_cfg(dtype))
    module = _common.load_weights(module, {k: v.to(dtype) for k, v in net.items()})
    return module, params


def _inputs(b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 4, 16, 16), generator=g)
    t = torch.rand((b,), generator=g)
    return x, t


def _call(module, params, x, t):
    b = x.shape[0]
    return module(x, t, context=params["cond.txt"].expand(b, -1, -1),
                  y=params["cond.y"].expand(b, -1), guidance=torch.full((b,), 3.5))


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_flux_against_reference(seed):
    module, params = _model(seed)
    x, t = _inputs(seed=seed)
    with torch.no_grad():
        got = _call(module, params, x, t)
    want = R.network(params, SMALL, x, t)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_flux_bf16_against_reference():
    """In bf16 both sides round the same operations to bf16 (the norms'
    statistics, RoPE, the logits and the softmax in float32), in orders that
    differ a little: within a few bf16 roundings of the output's size."""
    module, params = _model(5, torch.bfloat16)
    x, t = _inputs(seed=5)
    with torch.no_grad():
        got = _call(module, params, x, t)
    want = R.network(params, SMALL, x, t, torch.bfloat16)
    want32 = R.network(params, SMALL, x, t)
    err = float((got.float() - want).abs().max())
    assert err <= 4 * 2**-8 * float(want.abs().max()), err
    assert float((want - want32).abs().max()) > 0  # bf16 is not float32


def test_rope_turns_one_pair():
    """Pair j of axis 2 (the column) of a head with only that pair set is
    turned by ``col·θ^(−2j/a)``; text tokens are not turned."""
    cfg = _cfg()
    hp, wp, nt = 3, 4, 2
    cos, sin = FX._rope_table(hp, wp, nt, cfg.axes_dim, cfg.theta, torch.device("cpu"))
    n, d = nt + hp * wp, cfg.head_dim
    a0, a1, a2 = cfg.axes_dim
    j = 3                      # pair 3 of axis 2
    pair = a0 // 2 + a1 // 2 + j
    qk = torch.zeros(1, n, 2, 1, d)
    x0, x1 = 0.6, -0.8        # an RMS of one over the head after scaling by √(d/1)
    qk[..., 2 * pair] = x0 * math.sqrt(d)
    qk[..., 2 * pair + 1] = x1 * math.sqrt(d)
    ones = torch.ones(d)
    FX._qk_norm_rope(qk, [(slice(None), ones, ones)], cos, sin)
    rms = 1.0 / math.sqrt(1.0 + 1e-6)
    for token in range(n):
        col = 0 if token < nt else (token - nt) % wp
        ang = col * cfg.theta ** (-2.0 * j / a2)
        want0 = (math.cos(ang) * x0 - math.sin(ang) * x1) * math.sqrt(d) * rms
        want1 = (math.sin(ang) * x0 + math.cos(ang) * x1) * math.sqrt(d) * rms
        got = qk[0, token, :, 0]
        assert torch.allclose(got[:, 2 * pair], torch.tensor(want0), atol=1e-5), token
        assert torch.allclose(got[:, 2 * pair + 1], torch.tensor(want1), atol=1e-5), token
        others = torch.ones(d, dtype=torch.bool)
        others[2 * pair:2 * pair + 2] = False
        assert not got[:, others].any()


def test_rope_positions():
    """Axis 1 turns by the row, axis 2 by the column, axis 0 not at all."""
    cfg = _cfg()
    hp, wp, nt = 3, 4, 2
    cos, sin = FX._rope_table(hp, wp, nt, cfg.axes_dim, cfg.theta, torch.device("cpu"))
    ang = torch.atan2(sin, cos)[:, 0, 0]  # (n, d/2), the angles as they are below π
    a0, a1, _ = cfg.axes_dim
    token = nt + 2 * wp + 1            # row 2, column 1
    assert torch.equal(ang[:nt], torch.zeros_like(ang[:nt]))
    assert not ang[token, :a0 // 2].any()
    omega1 = cfg.theta ** (-torch.arange(0, a1, 2, dtype=torch.float64) / a1)
    torch.testing.assert_close(ang[token, a0 // 2:a0 // 2 + 1].double(), 2 * omega1[:1])
    torch.testing.assert_close(ang[token, (a0 + a1) // 2:(a0 + a1) // 2 + 1].double(),
                               1 * omega1.new_ones(1))


def test_qk_norm_is_rms_times_scale():
    cfg = _cfg()
    n, d = 5, cfg.head_dim
    cos, sin = torch.ones(n, 1, 1, d // 2), torch.zeros(n, 1, 1, d // 2)  # no turn
    g = torch.Generator().manual_seed(2)
    qk = torch.randn(2, n, 2, 3, d, generator=g) * 3
    sq, sk = torch.rand(d, generator=g) + 0.5, torch.rand(d, generator=g) + 0.5
    want = qk * torch.rsqrt(qk.square().mean(-1, keepdim=True) + 1e-6)
    want = want * torch.stack([sq, sk])[:, None, :]
    FX._qk_norm_rope(qk, [(slice(None), sq, sk)], cos, sin)
    torch.testing.assert_close(qk, want, rtol=1e-6, atol=1e-6)


def test_joint_sequence_order_and_split(monkeypatch):
    """With the attention core replaced by the identity on v, the packed
    qkv holds the text tokens first, and each stream gets back its own rows:
    the text stream's output is what its own v gives."""
    module, params = _model()
    blk = module.double_blocks[0]
    nt, ni, d = 8, 64, 96
    seen = []

    def identity_on_v(qkv, layout):
        seen.append(qkv.clone())
        b, n = qkv.shape[:2]
        return qkv[:, :, 2].reshape(b, n, -1)

    monkeypatch.setattr(FX, "fused_attention", identity_on_v)
    g = torch.Generator().manual_seed(4)
    img, txt, vec = (torch.randn(s, generator=g) for s in ((1, ni, d), (1, nt, d), (1, d)))
    pe = FX._rope_table(8, 8, nt, _cfg().axes_dim, 10000, torch.device("cpu"))
    with torch.no_grad():
        img_out, txt_out = blk(img, txt, vec, pe)
        qkv = seen[0]
        assert qkv.shape == (1, nt + ni, 3, 3, d // 3)
        tm, im = blk.txt_mod(vec), blk.img_mod(vec)
        txt_v = blk.txt_attn.qkv(FX._modulate(FX._layer_norm(txt), tm[0], tm[1]))[..., 2 * d:]
        img_v = blk.img_attn.qkv(FX._modulate(FX._layer_norm(img), im[0], im[1]))[..., 2 * d:]
        torch.testing.assert_close(qkv[:, :nt, 2].reshape(1, nt, d), txt_v)
        torch.testing.assert_close(qkv[:, nt:, 2].reshape(1, ni, d), img_v)
        want = txt + tm[2][:, None, :] * blk.txt_attn.proj(txt_v)
        want = want + tm[5][:, None, :] * blk.txt_mlp(FX._modulate(FX._layer_norm(want),
                                                                   tm[3], tm[4]))
        torch.testing.assert_close(txt_out, want)
        assert txt_out.shape == (1, nt, d) and img_out.shape == (1, ni, d)


def test_patchify_round_trip():
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    tok, hp, wp = FX._patchify(x)
    assert (hp, wp) == (2, 3) and tok.shape == (2, 6, 12)
    c, i, j = 1, 1, 0  # token (row 1, col 2) holds x[c, 2 + i, 4 + j] at c·4 + 2i + j
    assert tok[0, 1 * wp + 2, c * 4 + 2 * i + j] == x[0, c, 2 + i, 4 + j]
    assert torch.equal(FX._unpatchify(tok, hp, wp), x)


def test_denoiser_through_pipeline_with_flow():
    """``make_flux_denoiser`` in ``SonarPipeline`` with ``Flow(multiplier=1)``:
    one unguided call a step, the network conditioned on σ itself, CONST
    prediction and the rectified-flow split; the final latent equals the
    reference sampler's around the same denoiser and noise stream."""
    from benchmark.reference.noise import gaussian
    from benchmark.reference.samplers import sonar_euler_ancestral
    from sonar_tpu_torch.api.pipeline import SonarPipeline
    from sonar_tpu_torch.cfg import Flow
    from sonar_tpu_torch.noise.presets import get_noise_item

    module, params = _model()
    ms = Flow(multiplier=1.0)
    seen = []

    def recorded(x, t, **kw):
        seen.append(t.clone())
        return module(x, t, **kw)

    den = make_flux_denoiser(recorded, context=params["cond.txt"], y=params["cond.y"],
                             guidance=3.5, timestep_fn=ms.timestep)
    sigmas = torch.tensor([1.0, 0.6, 0.25, 0.05, 0.0])
    x0 = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(8))
    pipe = SonarPipeline(model=den, sampler="sonar_euler_ancestral", model_sampling=ms,
                         noise=get_noise_item("gaussian"))
    got = pipe(x0, sigmas, seed=77)
    assert [float(t[0]) for t in seen] == [float(s) for s in sigmas[:-1]]
    want = sonar_euler_ancestral.sample(den, x0, sigmas, ancestral_mode="rf",
                                        noise=gaussian.sampler(77, x0.shape, "cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 4, 16, 16), (2, 4, 8, 12)])
def test_flux_flops(shape):
    """The analytic count equals FlopCounterMode's on the module (every
    product is a linear or the attention core's two products)."""
    with torch.device("meta"):
        module = Flux(_cfg())
    b = shape[0]
    x, t = torch.zeros(shape, device="meta"), torch.ones(b, device="meta")
    with FlopCounterMode(display=False) as counter:
        module(x, t, context=torch.zeros(b, 8, 48, device="meta"),
               y=torch.zeros(b, 32, device="meta"), guidance=torch.ones(b, device="meta"))
    assert flux_forward_flops(_cfg(), shape, 8) == counter.get_total_flops()


def test_published_widths():
    """The defaults are ``configs["flux-dev"]``: 11,901,408,320 parameters."""
    with torch.device("meta"):
        module = Flux()
    assert sum(p.numel() for p in module.parameters()) == 11_901_408_320
    assert FluxConfig().head_dim == 128 == sum(FluxConfig().axes_dim)
