"""The port's UNet against the JAX UNet: the same parameters (mapped by
``unet_params_from_jax``) and the same numpy inputs through both.

Tolerance: 1e-4 relative to the output's largest magnitude — convolutions
and matrix products sum in another order in XLA and in PyTorch on the CPU.
Elementwise pieces are held to 1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonar_tpu.models.prediction as jpred
import sonar_tpu.models.unet as ju
import sonar_tpu_torch.models.prediction as tpred
import sonar_tpu_torch.models.unet as tu

REL = 1e-4
NARROW = dict(model_channels=16, channel_mult=(1, 2, 2), attention_levels=(1, 2),
              num_heads=2, norm_groups=4)


def _assert_close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, (err, rel * scale)


def _randomized(params, seed=0):
    """Every leaf redrawn at full scale (the JAX init zeroes biases and
    shrinks output convs, which would hide mapping errors)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree.flatten(params)
    out = []
    for leaf in flat:
        shape = leaf.shape
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            out.append(rng.standard_normal(shape) / np.sqrt(fan_in))
        else:
            out.append(0.1 * rng.standard_normal(shape) + (0.0 if leaf.sum() == 0 else 1.0))
    return jax.tree.unflatten(treedef, [np.asarray(a, np.float32) for a in out])


def _jax_init(cfg):
    return jax.jit(ju.init_unet_params, static_argnums=1)(jax.random.key(0), cfg)


def _port(params, cfg_kw):
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**cfg_kw))
    sd = tu.unet_params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def _inputs(shape, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    sigma = np.linspace(0.5, 9.0, shape[0]).astype(np.float32)
    return x, sigma


@pytest.mark.parametrize("hw", [8, 12])
def test_narrow_unet_matches_jax(hw):
    """8 and 12 pin the even-size SAME padding of the stride-2 downsample
    (0 before, 1 after); 12 → 6 → 3 runs three levels."""
    params = _randomized(_jax_init(ju.UNetConfig(**NARROW)))
    model = _port(params, NARROW)
    x, sigma = _inputs((2, 4, hw, hw))
    apply = jax.jit(lambda p, xi, si: ju.unet_apply(p, xi, si, ju.UNetConfig(**NARROW)))
    ref = apply(params, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        out = tu.unet_apply(model, torch.from_numpy(x), torch.from_numpy(sigma))
    _assert_close_rel(out.numpy(), ref)


def test_flagship_unet_matches_jax():
    """The flagship UNetConfig() (64 channels, mult (1,2,4), attention at
    levels 1 and 2) at 1×4×16×16, with the JAX init's own weights, through
    make_denoiser."""
    cfg = ju.UNetConfig()
    params = _jax_init(cfg)
    model = _port(params, {})
    x, sigma = _inputs((1, 4, 16, 16))
    ref = jax.jit(ju.make_denoiser(params, cfg))(jnp.asarray(x), jnp.asarray(sigma))
    out = tu.make_denoiser(model)(torch.from_numpy(x), torch.from_numpy(sigma))
    _assert_close_rel(out.numpy(), ref)
    raw_ref = jax.jit(lambda xi, si: ju.unet_apply(params, xi, si, cfg))(
        jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        raw = model(torch.from_numpy(x), torch.from_numpy(sigma))
    _assert_close_rel(raw.numpy(), raw_ref)


@pytest.mark.parametrize("hw", [(8, 8), (12, 12), (7, 9)])
def test_strided_conv_same_padding(hw):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((2, 5, *hw)).astype(np.float32)
    ref = ju._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                   jnp.asarray(x.transpose(0, 2, 3, 1)), stride=2)
    conv = tu.Conv(5, 6, 3, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(b))
        out = conv(torch.from_numpy(x))
    _assert_close_rel(out.numpy().transpose(0, 2, 3, 1), ref)


def test_nearest_upsample_matches_jax_resize():
    x = np.random.default_rng(4).standard_normal((1, 3, 5, 6)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (1, 10, 12, 3), "nearest")
    out = torch.nn.functional.interpolate(torch.from_numpy(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref))


@pytest.mark.parametrize("c,groups", [(16, 8), (12, 8), (6, 4)])
def test_group_norm_reduces_groups_like_jax(c, groups):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, c, 4, 4)).astype(np.float32) * 2 + 1
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ref = ju._group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x.transpose(0, 2, 3, 1)), groups)
    gn = tu._group_norm(c, groups)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        out = gn(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=0, atol=1e-5)


def test_sigma_embedding_matches_jax():
    sigma = np.asarray([0.03, 1.0, 14.6], np.float32)
    ref = ju._sigma_embedding(jnp.asarray(sigma), 64, jnp.float32)
    out = tu._sigma_embedding(torch.from_numpy(sigma), 64, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(jpred.PREDICTIONS))
def test_predictions_match_jax(name):
    rng = np.random.default_rng(6)
    x, out, noise = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32) for _ in range(3))
    sigma = np.asarray([0.3, 0.7], np.float32).reshape(-1, 1, 1, 1)
    jp, tp = jpred.get_prediction(name), tpred.get_prediction(name)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, out=out, noise=noise, s=sigma).items()}
    j = {k: jnp.asarray(v) for k, v in dict(x=x, out=out, noise=noise, s=sigma).items()}
    pairs = [
        (tp.calculate_input(t["s"], t["x"]), jp.calculate_input(j["s"], j["x"])),
        (tp.calculate_denoised(t["s"], t["out"], t["x"]),
         jp.calculate_denoised(j["s"], j["out"], j["x"])),
        (tp.noise_scaling(t["s"], t["noise"], t["x"]), jp.noise_scaling(j["s"], j["noise"], j["x"])),
        (tp.noise_scaling(t["s"], t["noise"], t["x"], max_denoise=True),
         jp.noise_scaling(j["s"], j["noise"], j["x"], max_denoise=True)),
        (tp.inverse_noise_scaling(t["s"], t["x"]), jp.inverse_noise_scaling(j["s"], j["x"])),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_init_unet_params_is_seeded_and_leaves_global_rng_alone():
    cfg = tu.UNetConfig(**NARROW)
    before = torch.random.get_rng_state()
    a = tu.init_unet_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = tu.init_unet_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), before)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # the port's state_dict has exactly the JAX tree's leaves
    shapes = jax.eval_shape(lambda k: ju.init_unet_params(k, ju.UNetConfig(**NARROW)),
                            jax.random.key(0))
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert set(tu.unet_params_from_jax(jparams)) == set(a.state_dict())
    w = a.state_dict()["conv_in.weight"]
    assert abs(float(w.std()) - (1.0 / np.sqrt(9 * 4))) < 0.05
    assert float(a.state_dict()["conv_out.weight"].abs().max()) < 0.05
