"""The check fails what it must: the control and each fault a cell can have
(``benchmark/faults.py``), planted under a run that is otherwise whole (at a
small size, on the CPU, past the harness's look for a card), with each
cell's own limit. ``calibrate.py --faults`` plants the same at the cells'
own sizes on the card."""

import pytest
from conftest import cells, small_cell

from benchmark import faults, harness

CELLS = cells()


def _run(name, seed=2**31 + 99):
    config, traffic = small_cell(name)
    return harness.run_cell(name, seed=seed, seconds=0.0, trace=False, device="cpu",
                            t_start=0.0, config=config, traffic=traffic, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_sound_run(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0


def _planted(name, fault, monkeypatch):
    config, traffic = small_cell(name)
    for owner, attr, value in faults.patches(fault, config, traffic):
        monkeypatch.setattr(owner, attr, value)
    r = _run(name)
    assert not r["correct"], r["checks"]
    assert r["checks"]["latent_gap"]["value"] > r["checks"]["latent_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_portbench_control_fails(name, monkeypatch):
    """The reference's network in bfloat16 as the program's denoisers."""
    _planted(name, "control", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_fault_step_unchanged(name, monkeypatch):
    _planted(name, "step_unchanged", monkeypatch)


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if faults.applies("half_batch", small_cell(n)[1])])
def test_portbench_fault_half_batch(name, monkeypatch):
    _planted(name, "half_batch", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_fault_answer_altered(name, monkeypatch):
    _planted(name, "answer_altered", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_fault_attention_axis(name, monkeypatch):
    """One layer kind wrong: attention's softmax over the queries."""
    _planted(name, "attention_axis", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_planted_is_undone(name):
    config, traffic = small_cell(name)
    from sonar_tpu_torch.models.unet import Attention

    before = Attention.forward
    with faults.planted("attention_axis", config, traffic):
        assert (Attention.forward is not before) == (config["family"] == "unet")
    assert Attention.forward is before
    with pytest.raises(ValueError):
        faults.patches("nothing", config, traffic)
