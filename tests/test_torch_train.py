"""The port's training tier against the JAX package, for the DiT: the loss
and gradients of one step (eps and flow objectives, Switch-MoE with its
auxiliary loss, bf16 compute), the remat settings and a falling loss; one
Adam step against ``optax.adam``, the draws, the EMA and checkpoints. The
UNet's cases are in ``tests/test_torch_train_unet.py``; both run the checks
of ``tests/_train_compare.py``, which says how the draws and JAX's gradients
are shared.

Tolerances: the loss within 1e-6 relative; gradients within 1e-4 of the
largest gradient of their tensor (products sum in another order); under bf16
compute as ``_train_compare.check_loss_and_grads`` states them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sonar_tpu.models.train as jt
import sonar_tpu_torch.models.checkpoint as tc
import sonar_tpu_torch.models.train as tt
import sonar_tpu_torch.models.unet as tu
from _train_compare import (CASES, UNET, batch_np, check_loss_and_grads, check_loss_decreases,  # noqa: F401
                            check_remat, family, one_thread)
from sonar_tpu_torch.models import (init_train_state, make_train_step, restore_checkpoint,
                                    save_checkpoint)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "dit"])
def test_loss_and_grads_match_jax(case, monkeypatch):
    check_loss_and_grads(case, monkeypatch)


def test_remat_gives_equal_grads():
    check_remat("dit")


def test_train_loss_decreases():
    check_loss_decreases("dit")


def test_adam_step_matches_optax():
    """Three Adam steps (lr 2e-3) on the same gradients: torch.optim.Adam
    against optax.adam, within 1e-6 relative (optax takes its bias
    corrections in float32, torch in Python floats)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (8, 5), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
          for _ in range(3)]
    opt = optax.adam(2e-3)
    jp, st = jax.tree.map(jnp.asarray, p0), opt.init(jax.tree.map(jnp.asarray, p0))
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = torch.optim.Adam(tp.values(), lr=2e-3)
    for g in gs:
        upd, st = opt.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_dots_policy_saves_the_dense_products():
    """"dots" keeps the non-batched matmuls (the dense layers) and recomputes
    the batched ones, as dots_with_no_batch_dims_saveable does."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    assert tt._dots_policy(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    assert tt._dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.convolution.default, aten.gelu.default):
        assert tt._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_train_draws_are_philox():
    """The step's draws are B3's stream on seeds derived from the step seed:
    reproducible, distinct per seed, the batch's shape."""
    batch = torch.zeros(3, 4, 8, 8)
    u, eps = tt.train_draws(5, batch)
    u2, eps2 = tt.train_draws(5, batch)
    assert u.shape == (3,) and eps.shape == batch.shape
    assert torch.equal(u, u2) and torch.equal(eps, eps2)
    assert bool(((u >= 0) & (u < 1)).all())
    assert not torch.equal(eps, tt.train_draws(6, batch)[1])


def test_ema_update_matches_jax():
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    ema = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    ref = jt.ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, params), 0.9)
    out = tt.ema_update({k: torch.from_numpy(v) for k, v in ema.items()},
                        {k: torch.from_numpy(v) for k, v in params.items()}, 0.9)
    for k in params:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-7, atol=0)
    # converges onto a fixed target
    e = {k: torch.zeros(v.shape) for k, v in params.items()}
    for _ in range(100):
        e = tt.ema_update(e, {k: torch.from_numpy(v) for k, v in params.items()}, 0.9)
    for k, v in params.items():
        np.testing.assert_allclose(e[k].numpy(), v, atol=1e-4)


def _trained(steps=2):
    model = family("unet", UNET)[2]
    opt = init_train_state(model, functools.partial(torch.optim.Adam, lr=2e-3))
    step = make_train_step(tu.UNetConfig(**UNET))
    batch = torch.from_numpy(batch_np(8))
    for i in range(steps):
        step(model, opt, batch, i)
    return model, opt, step, batch


def test_checkpoint_roundtrip_and_resume(tmp_path, monkeypatch):
    """Structure and values round-trip; the restored opt_state is accepted by
    a fresh optimizer, and the step after the restore equals the step of the
    uninterrupted run."""
    model, opt, step, batch = _trained()
    state = {"params": model.state_dict(), "opt_state": opt.state_dict(), "step": 2}
    path = tmp_path / "ckpt"
    save_checkpoint(path, state)
    monkeypatch.setattr(tc, "default_device", lambda device=None: torch.device("cpu"))
    restored = restore_checkpoint(path)
    assert restored["step"] == 2 and set(restored) == set(state)
    for k, v in state["params"].items():
        assert torch.equal(restored["params"][k], v)
    assert restored["opt_state"]["param_groups"] == state["opt_state"]["param_groups"]
    for i, s in state["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(restored["opt_state"]["state"][i][k], v)

    fresh = family("unet", UNET, seed=9)[2]
    fresh.load_state_dict(restored["params"])
    fresh_opt = init_train_state(fresh, functools.partial(torch.optim.Adam, lr=2e-3))
    fresh_opt.load_state_dict(restored["opt_state"])
    want = step(model, opt, batch, 2)
    got = step(fresh, fresh_opt, batch, 2)
    assert float(got) == float(want)
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_keeps_step_counts_on_the_host(tmp_path, monkeypatch):
    """A restore without a target moves every tensor to the default device
    (here ``meta``, a device other than the host) but for the optimizer's
    0-dim step counts, which stay on the host: torch's Adam keeps them where
    ``load_state_dict`` finds them, and reads them for every step."""
    model, opt, _, _ = _trained(1)
    state = {"params": model.state_dict(), "opt_state": opt.state_dict(), "step": 1}
    save_checkpoint(tmp_path / "ckpt", state)
    monkeypatch.setattr(tc, "default_device", lambda device=None: torch.device("meta"))
    got = restore_checkpoint(tmp_path / "ckpt")
    assert all(v.is_meta for v in got["params"].values())
    assert got["opt_state"]["param_groups"] == state["opt_state"]["param_groups"]
    assert set(got["opt_state"]["state"]) == set(state["opt_state"]["state"])
    for i, s in state["opt_state"]["state"].items():
        assert set(got["opt_state"]["state"][i]) == set(s) == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in got["opt_state"]["state"][i].items():
            if k == "step":
                assert v.device.type == "cpu" and torch.equal(v, s[k])
            else:
                assert v.is_meta and v.shape == s[k].shape


def test_checkpoint_target_partial_and_force(tmp_path):
    model, opt, _, _ = _trained(1)
    state = {"params": model.state_dict(), "opt_state": opt.state_dict(), "step": 1}
    path = tmp_path / "ckpt"
    save_checkpoint(path, state)
    with pytest.raises(FileExistsError):
        save_checkpoint(path, state)
    # a partial restore of the params, into the target's dtype and device
    target = {"params": {k: torch.zeros_like(v, dtype=torch.float64)
                         for k, v in model.state_dict().items()}}
    got = restore_checkpoint(path, target=target, partial=True)
    assert set(got) == {"params"}
    for k, v in model.state_dict().items():
        assert got["params"][k].dtype == torch.float64 and got["params"][k].device.type == "cpu"
        assert torch.equal(got["params"][k], v.double())
    with pytest.raises(KeyError):  # a subtree needs partial=True
        restore_checkpoint(path, target=target)
    full = restore_checkpoint(path, target=state)
    assert full["step"] == 1 and torch.equal(full["params"]["conv_in.weight"],
                                             state["params"]["conv_in.weight"])
    bad = {"params": dict(target["params"], **{"conv_in.weight": torch.zeros(1)})}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, target=bad, partial=True)
    # force replaces the directory whole; nothing is left beside it
    save_checkpoint(path, {"step": 5}, force=True)
    assert restore_checkpoint(path, target={"step": 0}) == {"step": 5}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]
