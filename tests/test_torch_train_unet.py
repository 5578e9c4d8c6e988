"""The port's training step for the UNet against the JAX package's: the loss
and gradients of one step (eps and flow objectives, bf16 compute), the remat
settings and a falling loss (``tests/_train_compare.py``'s checks; the DiT's
cases, the optimizer, the EMA and checkpoints are in
``tests/test_torch_train.py``)."""

import pytest

from _train_compare import (CASES, check_loss_and_grads, check_loss_decreases,  # noqa: F401
                            check_remat, one_thread)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "unet"])
def test_loss_and_grads_match_jax(case, monkeypatch):
    check_loss_and_grads(case, monkeypatch)


def test_remat_gives_equal_grads():
    check_remat("unet")


def test_train_loss_decreases():
    check_loss_decreases("unet")
