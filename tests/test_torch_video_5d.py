"""The port's 5-D sweep: every noise node draws a (B, C, F, H, W) latent
(the port of ``tests/test_video_5d.py::test_every_noise_node_draws_5d``).

Every node of the port's node API that builds a noise item is built with
its link inputs (``tests/_parallel_worlds.noise_nodes``, the link factories
of ``tests/test_schema_validation.py`` at CPU tensors) and drawn once at
1×4×3×8×8. The five nodes whose items the JAX package's test expects to
refuse a raw 5-D latent (the reference refuses it too) refuse here, and
every other node draws finite noise of the latent's shape. The sharded
case of the sweep (frames on sp) is in ``test_torch_parallel_noise.py``.
"""

import pytest
import torch

from _parallel_worlds import noise_nodes
from sonar_tpu_torch.api.nodes import build
from sonar_tpu_torch.noise import make_noise_sampler

SHAPE = (1, 4, 3, 8, 8)
# tests/test_video_5d.py:78-88: Voronoi and scatternet are 4-D spatial, the
# power items unpack four dimensions, and the sweep's 4-D latent link makes
# GuidedNoise a broadcast error
EXPECTED_UNSUPPORTED = {"SonarAdvancedVoronoiNoise", "SonarGuidedNoise",
                        "SonarPowerFilterNoise", "SonarPowerNoise",
                        "SonarScatternetFilteredNoise"}
NODES = noise_nodes()


def _draw(item, shape=SHAPE):
    fn, st = make_noise_sampler(item, shape, device="cpu", seed=0, sigma_min=0.03,
                                sigma_max=14.6)
    return fn(st, 1.0, 0.9)[0]


def test_the_sweep_is_whole():
    assert len(NODES) >= 25, sorted(NODES)
    assert EXPECTED_UNSUPPORTED <= set(NODES)


@pytest.mark.parametrize("name", sorted(NODES))
def test_every_noise_node_draws_5d(name):
    """A node draws finite 5-D noise of the latent's shape, or, for the five
    the reference refuses, raises."""
    if name in EXPECTED_UNSUPPORTED:
        with pytest.raises(Exception):  # noqa: B017 (each refuses in its own way)
            _draw(NODES[name])
        return
    out = _draw(NODES[name])
    assert tuple(out.shape) == SHAPE and bool(torch.isfinite(out).all())


def test_guided_noise_draws_5d_on_a_5d_guide():
    """GuidedNoise supports 5-D when its guide latent is 5-D."""
    g = build("SonarGuidedNoise", latent=torch.zeros(SHAPE),
              sonar_custom_noise=build("SonarCustomNoise", factor=1.0, noise_type="gaussian"))
    out = _draw(g)
    assert tuple(out.shape) == SHAPE and bool(torch.isfinite(out).all())
