"""What ``tests/test_torch_train.py`` and ``tests/test_torch_train_unet.py``
share: the two families' small configurations, the JAX trees drawn with
numpy and mapped onto the port's modules, JAX's draws and gradients of one
step, and the checks both files run for their family.

The two packages draw from different generators, so the port's draw function
(``sonar_tpu_torch.models.train.train_draws``) is replaced by JAX's own
``split``/``uniform``/``normal`` of the same key. JAX's gradients are read
through an optax transformation that returns zero updates and the gradients
as its new state; the port's are left in ``.grad`` by the step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sonar_tpu.models.dit as jd
import sonar_tpu.models.train as jt
import sonar_tpu.models.unet as ju
import sonar_tpu_torch.models.dit as td
import sonar_tpu_torch.models.train as tt
import sonar_tpu_torch.models.unet as tu
from sonar_tpu_torch.models import init_train_state, make_train_step

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The steps here run on tensors of a few thousand elements: torch's
    intra-op threads only contend with the other test workers' (several
    times slower with the suite's six workers), so one thread, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, attention_levels=(1,),
            num_heads=4, norm_groups=4)
DIT = dict(hidden=64, depth=2, num_heads=4)
MOE = dict(DIT, num_experts=4, capacity_factor=1.0)
SHAPE = (2, 4, 16, 16)
# Switch routing is an argmax: the MoE cases hold at their seeds only where
# every token's top two router probabilities are this far apart, far above
# the ~1e-6 by which the two sides' logits differ
MARGIN = 1e-4


def randomized(params, seed, conv: bool):
    """Every leaf of the JAX init's tree (shapes only: ``jax.eval_shape``
    traces it and draws nothing) drawn with numpy: weights at full scale
    (std 1/sqrt(fan_in); HWIO convolutions when ``conv``), biases 0.1, norm
    scales 1 ± 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "w":
            fan_in = a.shape[-2] * (a.shape[0] * a.shape[1] if conv and a.ndim == 4 else 1)
            out = rng.standard_normal(a.shape) / np.sqrt(fan_in)
        else:
            out = 0.1 * rng.standard_normal(a.shape) + (1.0 if leaf == "scale" else 0.0)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def family(kind, cfg_kw, seed=0):
    """(JAX config, JAX params, port module, JAX→port mapping)."""
    if kind == "unet":
        jcfg, init, port_cls = ju.UNetConfig(**cfg_kw), ju.init_unet_params, tu.UNet
        port_cfg, to_port = tu.UNetConfig(**cfg_kw), tu.unet_params_from_jax
    else:
        jcfg, init, port_cls = jd.DiTConfig(**cfg_kw), jd.init_dit_params, td.DiT
        port_cfg, to_port = td.DiTConfig(**cfg_kw), td.dit_params_from_jax
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.key(seed))
    params = randomized(shapes, seed, conv=kind == "unet")
    with torch.device("meta"):
        model = port_cls(port_cfg)
    model.load_state_dict(to_port(params), strict=True, assign=True)
    return jcfg, params, model, to_port


def jax_draws(seed, batch):
    """JAX's draws of make_train_step for the key of ``seed``."""
    ksig, keps = jax.random.split(jax.random.key(seed))
    u = jax.random.uniform(ksig, (batch.shape[0],), jnp.float32)
    eps = jax.random.normal(keps, tuple(batch.shape), jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(eps))


GRAB = optax.GradientTransformation(
    lambda p: (), lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def batch_np(seed=1):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def port_grads(model, step, batch, seed):
    opt = init_train_state(model, functools.partial(torch.optim.SGD, lr=0.0))
    loss = step(model, opt, torch.from_numpy(batch), seed)
    return float(loss), {k: p.grad for k, p in model.named_parameters()}


def close_grads(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].double().numpy(), w.double().numpy()
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rel * max(scale, 1e-12), (k, err, scale)


CASES = {
    "unet-eps": ("unet", UNET, {}),
    "unet-flow": ("unet", UNET, dict(objective="flow", flow_shift=3.0)),
    "dit-eps": ("dit", DIT, {}),
    "dit-flow": ("dit", DIT, dict(objective="flow", flow_shift=3.0)),
    "moe-aux": ("dit", MOE, dict(aux_weight=0.1)),
    "unet-bf16": ("unet", UNET, dict(compute_dtype="bf16")),
    "dit-bf16": ("dit", DIT, dict(compute_dtype="bf16")),
}


_JAX_RESULTS = {}


def jax_loss_grads(kind, cfg_kw, kw, batch, seed):
    """JAX's loss and gradients (mapped to the port's names) of one step on
    the randomized weights, computed once per case and batch in a worker."""
    batch = np.ascontiguousarray(batch)
    key = (kind, repr(sorted(cfg_kw.items())), repr(sorted(kw.items())), seed,
           batch.shape, batch.dtype.str, batch.tobytes())
    if key not in _JAX_RESULTS:
        jcfg, params, _, to_port = family(kind, cfg_kw)
        jkw = dict(kw, compute_dtype=jnp.bfloat16) if kw.get("compute_dtype") else kw
        _, grads, loss = jax.jit(jt.make_train_step(jcfg, GRAB, **jkw))(
            params, (), jnp.asarray(batch), jax.random.key(seed))
        _JAX_RESULTS[key] = float(loss), to_port(jax.tree.map(np.asarray, grads))
    return _JAX_RESULTS[key]


def check_loss_and_grads(case, monkeypatch):
    """float32: the loss within 1e-6 relative, each gradient within 1e-4 of
    its tensor's largest. bf16 compute: XLA keeps some intermediates of a
    fused chain in float32 where PyTorch rounds every operator's output, so
    the two bf16 steps differ by about what bf16 costs either of them (JAX's
    own bf16 gradients are 1-2 % of the largest gradient from its float32
    ones at these sizes): the loss within 2⁻⁸ relative, every gradient within
    2⁻⁵ of the model's largest, and the port's bf16 gradients no further from
    its float32 ones than 1.5 × JAX's distance between its own two, and no
    nearer than a quarter of it: a step that ignored ``compute_dtype`` would
    sit at 0. Every dense layer and convolution of the forward computes in
    bf16, on master weights and gradients that stay float32."""
    kind, cfg_kw, kw = CASES[case]
    bf16 = kw.get("compute_dtype") == "bf16"
    f32_kw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    tkw = dict(f32_kw, compute_dtype=torch.bfloat16) if bf16 else kw
    batch, seed = batch_np(), 3
    jloss, want = jax_loss_grads(kind, cfg_kw, kw, batch, seed)
    monkeypatch.setattr(tt, "train_draws", jax_draws)
    tcfg = (tu.UNetConfig if kind == "unet" else td.DiTConfig)(**cfg_kw)
    model = family(kind, cfg_kw)[2]
    gaps = []  # the MoE routing precondition: no near-tie in any router
    hooks = [blk.router.register_forward_hook(lambda mod, args, out: gaps.append(
        float(torch.softmax(out.detach().float(), -1).topk(2, -1).values.diff(dim=-1).abs().min())))
        for blk in getattr(model, "blocks", ()) if hasattr(blk, "router")]
    layer_dtypes = []  # the dtypes the dense layers and convolutions compute in
    hooks += [mod.register_forward_hook(lambda mod, args, out: layer_dtypes.append(out.dtype))
              for mod in model.modules()
              if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d))]
    loss, grads = port_grads(model, make_train_step(tcfg, **tkw), batch, seed)
    for h in hooks:
        h.remove()
    assert min(gaps, default=1.0) >= MARGIN
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert layer_dtypes and set(layer_dtypes) == {torch.bfloat16 if bf16 else torch.float32}
    if not bf16:
        assert abs(loss - jloss) <= 1e-6 * abs(jloss)
        close_grads(grads, want, 1e-4)
        return
    assert abs(loss - jloss) <= 2.0**-8 * abs(jloss)
    _, want32 = jax_loss_grads(kind, cfg_kw, f32_kw, batch, seed)
    _, grads32 = port_grads(family(kind, cfg_kw)[2], make_train_step(tcfg, **f32_kw), batch,
                             seed)
    top = max(float(w.abs().max()) for w in want32.values())

    def dist(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in b) / top

    assert dist(grads, want) <= 2.0**-5, dist(grads, want)
    assert 0.25 * dist(want, want32) <= dist(grads, grads32) <= 1.5 * dist(want, want32), (
        dist(grads, grads32), dist(want, want32))


def check_remat(kind):
    """Remat changes what is kept for the backward, not the math."""
    cfg_kw = UNET if kind == "unet" else MOE
    tcfg = (tu.UNetConfig if kind == "unet" else td.DiTConfig)(**cfg_kw)
    batch = batch_np(2)
    results = {}
    for remat in (False, True, "full", "dots"):
        model = family(kind, cfg_kw)[2]
        results[remat] = port_grads(model, make_train_step(tcfg, remat=remat), batch, 4)
    loss0, g0 = results[False]
    for remat, (loss, g) in results.items():
        assert loss == pytest.approx(loss0, rel=1e-6), remat
        close_grads(g, g0, 1e-6)
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_train_step(tcfg, remat="bogus")
    with pytest.raises(ValueError, match="objective"):
        make_train_step(tcfg, objective="v")


def check_loss_decreases(kind):
    """Eight Adam steps at lr 2e-3 on a fixed batch and step seed (the port's
    own Philox draws): the loss falls by more than 10 %, at float32 and
    under bf16 compute (float32 master weights, first loss within 5 % of the
    float32 one)."""
    cfg_kw = UNET if kind == "unet" else DIT
    tcfg = (tu.UNetConfig if kind == "unet" else td.DiTConfig)(**cfg_kw)
    batch = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 4, 16, 16))
                             .astype(np.float32))
    losses = {}
    for dt in (None, torch.bfloat16):
        model = family(kind, cfg_kw, seed=6)[2]
        opt = init_train_state(model, functools.partial(torch.optim.Adam, lr=2e-3))
        step = make_train_step(tcfg, compute_dtype=dt)
        losses[dt] = [float(step(model, opt, batch, 2)) for _ in range(8)]
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert np.isfinite(losses[dt]).all() and losses[dt][-1] < 0.9 * losses[dt][0], losses
    assert abs(losses[torch.bfloat16][0] - losses[None][0]) < 0.05 * losses[None][0]
