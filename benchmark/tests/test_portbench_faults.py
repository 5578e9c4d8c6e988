"""The check fails what it must: the control and each fault a cell can have
(``benchmark/faults.py``), planted under a run that is otherwise whole (at a
small size, on the CPU, past the harness's look for a card), with each
cell's own limit, in every cell and in the mixes only the tests run.
``calibrate.py --faults`` plants the same at the cells' own sizes on the
card."""

import pytest
from conftest import cell_traffic, cells, run_small, small_cell

from benchmark import faults

CELLS = cells()
SEED = 2**31 + 99


@pytest.mark.parametrize("name", CELLS)
def test_portbench_sound_run(name):
    r = run_small(name, SEED)
    assert r["correct"] and r["failed"] == 0, r["checks"]


def _planted(name, fault, monkeypatch):
    config, traffic = small_cell(name)
    if not faults.applies(fault, traffic):
        pytest.fail(f"{fault} does not apply to {name}")
    for owner, attr, value in faults.patches(fault, config, traffic):
        monkeypatch.setattr(owner, attr, value)
    r = run_small(name, SEED)
    assert not r["correct"], r["checks"]
    assert r["checks"]["latent_gap"]["value"] > r["checks"]["latent_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_portbench_control_fails(name, monkeypatch):
    """The family's reference network in bfloat16 as the program's
    denoisers, under the traffic's prediction and CFG mode."""
    _planted(name, "control", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_fault_step_unchanged(name, monkeypatch):
    _planted(name, "step_unchanged", monkeypatch)


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if faults.applies("half_batch", cell_traffic(n))])
def test_portbench_fault_half_batch(name, monkeypatch):
    _planted(name, "half_batch", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_fault_answer_altered(name, monkeypatch):
    _planted(name, "answer_altered", monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_portbench_fault_attention_axis(name, monkeypatch):
    """One layer kind wrong: attention's softmax over the queries."""
    _planted(name, "attention_axis", monkeypatch)


def test_portbench_fault_needs_its_family_file(monkeypatch):
    """A family whose file has no ``attention_axis`` fails that fault by
    name; it is never handled as another family."""
    import importlib

    config, traffic = small_cell(CELLS[0])
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    monkeypatch.delattr(family, "attention_axis")
    with pytest.raises(LookupError, match=f"families/{config['family']}.py has no attention_axis"):
        faults.patches("attention_axis", config, traffic)


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("name", CELLS)
def test_portbench_planted_is_undone(name, fault):
    config, traffic = small_cell(name)
    done = faults.patches(fault, config, traffic)
    before = [getattr(owner, attr) for owner, attr, _ in done]
    with faults.planted(fault, config, traffic):
        assert all(getattr(owner, attr) is not b for (owner, attr, _), b in zip(done, before))
    assert [getattr(owner, attr) for owner, attr, _ in done] == before
    with pytest.raises(ValueError):
        faults.patches("nothing", config, traffic)
