"""The port's FLOP counters: equal to the JAX package's on its configurations
(pure arithmetic, so exactly), and held against
``torch.utils.flop_counter.FlopCounterMode`` on the port's own modules within
the bands ``tests/test_flops.py`` holds the JAX counts to against XLA's cost
analysis (the modules are built on the meta device: the counter reads
shapes, nothing is computed).

FlopCounterMode counts matmuls, batched matmuls and convolutions at two
FLOPs a multiply-accumulate, as the analytic counters do; it counts a
"SAME" convolution's padded border taps too, so the UNet's two counts come
out nearly equal, where XLA's sat a few percent below.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import sonar_tpu.models.dit as jd
import sonar_tpu.models.flops as jf
import sonar_tpu.models.unet as ju
import sonar_tpu_torch.models.dit as td
import sonar_tpu_torch.models.unet as tu
from sonar_tpu_torch.models import (H100_PEAK_FLOPS, dit_forward_flops, mfu_pct,
                                    unet_forward_flops)

UNETS = [
    (dict(), (1, 4, 32, 32)),
    (dict(model_channels=96, channel_mult=(1, 2, 4), num_res_blocks=2,
          attention_levels=(1, 2), num_heads=8, norm_groups=32), (2, 4, 64, 64)),
    (dict(), (1, 4, 64, 64)),  # the flagship at the headline's latent
]
DITS = [
    (dict(hidden=128, depth=4, num_heads=4), (1, 4, 32, 32)),
    (dict(hidden=192, depth=6, num_heads=6, num_experts=4), (2, 4, 32, 32)),
    (dict(hidden=384, depth=12, num_heads=6, patch_size=2), (1, 4, 64, 64)),  # DiT-S/2
]


def _counted(model, shape) -> int:
    x = torch.zeros(shape, device="meta")
    sigma = torch.ones(shape[0], device="meta")
    with FlopCounterMode(display=False) as counter:
        model(x, sigma)
    return counter.get_total_flops()


@pytest.mark.parametrize("cfg_kw,shape", UNETS)
def test_unet_flops(cfg_kw, shape):
    ours = unet_forward_flops(tu.UNetConfig(**cfg_kw), shape)
    assert ours == jf.unet_forward_flops(ju.UNetConfig(**cfg_kw), shape)
    with torch.device("meta"):
        model = tu.UNet(tu.UNetConfig(**cfg_kw))
    counted = _counted(model, shape)
    assert 0.95 * counted <= ours <= 1.10 * counted, (ours, counted)


@pytest.mark.parametrize("cfg_kw,shape", DITS)
def test_dit_flops(cfg_kw, shape):
    ours = dit_forward_flops(td.DiTConfig(**cfg_kw), shape)
    assert ours == jf.dit_forward_flops(jd.DiTConfig(**cfg_kw), shape)
    with torch.device("meta"):
        model = td.DiT(td.DiTConfig(**cfg_kw))
    counted = _counted(model, shape)
    assert 0.80 * counted <= ours <= 1.05 * counted, (ours, counted)


def test_bench_model_magnitudes():
    """The two bench models at the headline's 1×4×64×64: the flagship UNet
    and DiT-S/2 (bench.py:174)."""
    unet = unet_forward_flops(tu.UNetConfig(), (1, 4, 64, 64))
    dit = dit_forward_flops(td.DiTConfig(hidden=384, depth=12, num_heads=6), (1, 4, 64, 64))
    assert round(unet / 1e9, 2) == 14.35 and round(dit / 1e9, 2) == 62.86
    assert unet_forward_flops(tu.UNetConfig(), (4, 4, 64, 64)) == 4 * unet


def test_mfu_pct():
    assert H100_PEAK_FLOPS == 989.4e12
    assert mfu_pct(H100_PEAK_FLOPS / 2, 500.0) == pytest.approx(100.0)
    assert mfu_pct(197e12 / 2, 500.0, peak=197e12) == pytest.approx(100.0)
    assert mfu_pct(1.0, None) is None and mfu_pct(1.0, 0.0) is None
