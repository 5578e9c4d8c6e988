"""The program's weights are gone before the reference makes its own: two
copies of a large configuration's weights do not fit on one card. On the
CPU, through a whole small run. On the card (marked ``cuda``): one draw of
11.9e9 float32 weights (47.6 GB, FLUX.1-dev's size), freed, then drawn
again; and a whole run of a DiT of 11.9e9 parameters, whose reference
could not make its weights beside the program's."""

import gc
import math
import weakref

import pytest
import torch
from conftest import cells, run_small

from benchmark import check, harness, weights
from benchmark import traffic as T


@pytest.mark.parametrize("name", cells())
def test_portbench_program_weights_freed_before_check(name, monkeypatch):
    """When the check starts, no tensor the program's weights were made as
    is alive, and no live tensor holds their storage."""
    program, alive = {}, []
    real_make, real_compare = weights.make, check.compare

    def make(*a, **k):
        out = real_make(*a, **k)
        if not program:  # the first draw is the program's
            program["refs"] = [weakref.ref(t) for t in out.values()]
            program["ptr"] = next(iter(out.values())).untyped_storage().data_ptr()
        return out

    def compare(*a, **k):
        gc.collect()
        alive.append(sum(r() is not None for r in program["refs"]))
        alive.append(sum(1 for o in gc.get_objects() if issubclass(type(o), torch.Tensor)
                         and o.untyped_storage().data_ptr() == program["ptr"]))
        return real_compare(*a, **k)

    monkeypatch.setattr(weights, "make", make)
    monkeypatch.setattr(check, "compare", compare)
    assert run_small(name, 3)["correct"]
    assert alive == [0, 0], "the program's weights are alive when the check starts"


@pytest.mark.cuda
def test_portbench_large_weights_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = 11_900_000_000
    specs = [("w", (n,), 0.0, 1.0)]
    torch.cuda.reset_peak_memory_stats()
    w = weights.make(specs, 2**31 + 5, "cuda")["w"]
    first = w[-4:].tolist()
    assert torch.cuda.memory_allocated() >= 4 * n
    assert w[:: n // 1000].std().item() == pytest.approx(1.0, abs=0.1)
    del w
    gc.collect()
    torch.cuda.empty_cache()
    w = weights.make(specs, 2**31 + 5, "cuda")["w"]
    assert w[-4:].tolist() == first
    assert torch.cuda.max_memory_allocated() < 2 * 4 * n


@pytest.mark.cuda
def test_portbench_large_program_freed_on_card():
    """DiT-XL/2's family at FLUX.1-dev's hidden 3,072 and 24 heads, 70
    blocks deep (11.91e9 parameters), two unguided steps of one 256-px
    latent: the program, freed, then the reference on its own weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    config = dict(T.load("configs", "dit-xl2"), hidden=3072, num_heads=24, depth=70)
    traffic = dict(T.load("traffic", "512-b4"), shape=[1, 4, 32, 32], steps=2,
                   cfg={"mode": "none"})
    from benchmark.reference import dit

    n = sum(math.prod(s) for _, s, _, _ in dit.param_specs(config))
    assert n > 11.9e9
    bench = dict(harness.load_bench(), workloads=[{"name": "large", "config": "dit-xl2",
                                                   "traffic": "512-b4", "chips": 1}])
    torch.cuda.reset_peak_memory_stats()
    r = harness.run_cell("large", seed=2**31 + 7, seconds=0.0, trace=False, device="cuda",
                         t_start=0.0, bench=bench, config=config, traffic=traffic,
                         limits={"latent_gap": {"limit": float("inf")}}, log=print)
    peak = torch.cuda.max_memory_allocated()
    print({"params": n, "program_peak_bytes": r["device"]["memory_peak_bytes"],
           "peak_bytes": peak, "latent_gap": r["checks"]["latent_gap"]["value"]})
    assert r["failed"] == 0 and r["device"]["memory_peak_bytes"] >= 4 * n
    assert peak < 1.5 * 4 * n
