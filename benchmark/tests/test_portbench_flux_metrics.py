"""The readers of the FLUX cell's two per-layer metrics on made-up traces
and ``span_totals()``: ``rope_qknorm_ms`` (the ``sonar.rope`` spans over the
model calls) and ``attention_roofline_pct`` (B7's least time over its
device time), and where each finds nothing to read."""

import pytest

from benchmark.families import flux
from benchmark.metrics import attention_roofline_pct, rope_qknorm_ms
from sonar_tpu_torch.utils import profiling

CONFIG = {"family": "flux", "hidden_size": 3072, "num_heads": 24, "context_tokens": 512, "matmul_allow_tf32": True}
TRAFFIC = {"shape": [1, 16, 128, 128]}
TF32 = "void (anonymous namespace)::attention_tf32_kernel<Tf32<128, 2> >(Args)"
FFMA = "void (anonymous namespace)::attention_ffma_kernel<Ffma<128, 16, 32, 4> >(Args)"
OTHER = "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32"
SPANS = {"sonar.model": {"count": 20, "device_ms": 10000.0},
         "sonar.rope": {"count": 1140, "device_ms": 700.0},
         "sonar.attention": {"count": 1140, "device_ms": 4600.0}}


def _run(launches, seconds, name=TF32, tf32=True):
    ops = [{"name": name, "kind": "kernel", "start": 0, "end": int(seconds * 1e9)}] * launches
    ops += [{"name": OTHER, "kind": "kernel", "start": 0, "end": 10**9},
            {"name": "Memcpy HtoD", "kind": "memcpy", "start": 0, "end": 10}]
    return {"trace": {"ops": ops}, "config": dict(CONFIG, matmul_allow_tf32=tf32),
            "traffic": TRAFFIC}


def test_rope_reader(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: SPANS)
    assert rope_qknorm_ms.read(_run(0, 0)) == pytest.approx(35.0)  # 700 ms over 20 calls


@pytest.mark.parametrize("case", ["no trace", "no rope span", "no span_totals"])
def test_rope_reader_finds_nothing(monkeypatch, case):
    run = _run(0, 0)
    monkeypatch.setattr(profiling, "span_totals", lambda: SPANS)
    if case == "no trace":
        run = {"trace": None}
    elif case == "no rope span":  # a model without RoPE, or a program before it
        monkeypatch.setattr(profiling, "span_totals",
                            lambda: {k: v for k, v in SPANS.items() if k != "sonar.rope"})
    else:
        monkeypatch.delattr(profiling, "span_totals")
    assert rope_qknorm_ms.read(run) is None


def test_attention_flops_at_the_cell():
    """4·heads·n²·d at n = 4,096 + 512 tokens and d = 128: 2.609e11."""
    assert flux.attention_launch_flops(CONFIG, TRAFFIC["shape"]) == 4.0 * 24 * 4608**2 * 128


@pytest.mark.parametrize("tf32, name, peak", [(True, TF32, 495e12), (False, FFMA, 67e12)])
def test_attention_roofline_reader(tf32, name, peak):
    least = 4.0 * 24 * 4608**2 * 128 / peak
    run = _run(57, 2 * least, name, tf32)
    assert attention_roofline_pct.read(run) == pytest.approx(50.0)


@pytest.mark.parametrize("case", ["no trace", "no kernel", "no count in the family"])
def test_attention_roofline_reader_finds_nothing(case):
    run = {"trace": None} if case == "no trace" else _run(0 if case == "no kernel" else 57, 1e-3)
    if case == "no count in the family":  # a family whose launches differ in shape
        run["config"]["family"] = "unet"
    assert attention_roofline_pct.read(run) is None
