"""Every noise type of the port on a sharded latent: each rank draws its
block of the whole latent's draw (the contract of ``make_noise_sampler``'s
``shard=``).

One gloo world of 4 CPU ranks (``tests/_parallel_worlds.parallel_noise_world``)
draws every case; each test compares the ranks' blocks with the slice of the
port's own unsharded draw, made here. The unsharded draws are held against
the JAX package by the zoo tests (``test_torch_noise_zoo.py`` and the rest).
The layouts are ``test_torch_parallel.py``'s: batch on dp (4, 4, 16, 16), a
rank's block starting inside a Philox group of four (4, 3, 5, 7), and the
frames of a (1, 4, 8, 16, 16) latent on sp.

Tolerances: a draw normalized with the whole latent's statistics 1e-6
relative to max(1, |x|) (kernel B2 split's sums over the ranks are float64,
B2's over the whole latent float32); an unnormalized draw bit for bit where
no sum runs over the ranks (``EXACT_UNNORMALIZED``), and 1e-6 relative where
one still does (a mix's members and a hooked generator normalize inside,
and B4's and B5's plain sums run over a shard's planes in another batch).
"""

import math

import numpy as np
import pytest

import sonar_tpu_torch.parallel as tp
from _parallel_worlds import (NOISE_LAYOUTS, SWEEP_SHAPE, VIDEO_SHAPE, _draws,
                              combinator_trees, noise_nodes, parallel_noise_world, video_item)
from sonar_tpu_torch.kernels.fused_pyramid import fused_downscale_pyramid
from sonar_tpu_torch.noise import get_noise_item
from sonar_tpu_torch.noise.presets import noise_type_names

RANKS = 4
REL = 1e-6
NAMES = list(noise_type_names())
# Voronoi is 4-D spatial: a raw 5-D latent is refused, unsharded, in both
# packages (tests/test_video_5d.py:90-101)
VORONOI = ("voronoi_fuzz", "voronoi_mix")
# the draws that run no sum over the ranks when nothing normalizes: the
# others normalize inside (a mix's members, green_test's std, a hooked
# generator's default) and meet B2 split's float64 sums
EXACT_UNNORMALIZED = ("gaussian", "uniform", "brownian", "perlin", "studentt", "pink_old",
                      "power_old", "white", "grey", "velvet", "violet", "pyramid_old",
                      "pyramid_old_area", "pyramid_old_bislerp", "distro", "collatz")
# the five node builders whose items refuse a raw 5-D latent in the JAX package
# too (tests/test_video_5d.py:78-88)
UNSUPPORTED_5D = {"SonarAdvancedVoronoiNoise", "SonarGuidedNoise", "SonarPowerFilterNoise",
                  "SonarPowerNoise", "SonarScatternetFilteredNoise"}


def _close_rel(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), max(1.0, float(np.abs(b).max()))
    assert err <= rel * scale, (err, rel * scale)


@pytest.fixture(scope="module")
def world():
    return tp.run_world(parallel_noise_world, RANKS, backend="gloo", device_type="cpu",
                        args=({},))


def _block(full, box):
    offset, local = box
    return full[tuple(slice(o, o + n) for o, n in zip(offset, local))]


def _held(world, key, full, box_key, exact=False):
    for r in world:
        got = r[key]
        assert not (isinstance(got, tuple) and got[0] == "raised"), got
        for g, f in zip(got, full):
            want = _block(f, r["boxes"][box_key])
            if exact:
                np.testing.assert_array_equal(g, want)
            else:
                _close_rel(g, want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("layout", list(NOISE_LAYOUTS))
def test_every_noise_name_draws_its_block(world, layout, name):
    """Each rank's block of both draws (the second reads the first's state)
    equals the unsharded draw's slice, normalized and not."""
    shape = NOISE_LAYOUTS[layout]
    if layout == "sp" and name in VORONOI:
        for r in world:
            got = r[("name", layout, name, True)]
            assert got[:2] == ("raised", "ValueError") and "at most 4" in got[2]
        with pytest.raises(ValueError, match="at most 4"):
            _draws(get_noise_item(name), shape)
        return
    _held(world, ("name", layout, name, True), _draws(get_noise_item(name), shape), layout)
    _held(world, ("name", layout, name, False),
          _draws(get_noise_item(name), shape, normalized=False), layout,
          exact=name in EXACT_UNNORMALIZED)


@pytest.mark.parametrize("tree", list(combinator_trees()))
def test_combinator_trees_draw_their_block(world, tree):
    """Combinator trees, among them ShuffledNoise and PerDimNoise along the
    split axis (drawn whole on every rank, the block kept) and the items that
    reduce over the whole latent (gathered from the ranks' blocks)."""
    item, layout = combinator_trees()[tree]
    _held(world, ("tree", tree), _draws(item, NOISE_LAYOUTS[layout]), layout)


def test_video_noise_frames_on_sp(world):
    """Config 5's video noise (time-Brownian power noise, frames folded into
    the channels) on a 1×4×16×16×16 latent with its frames on sp."""
    _held(world, "video", _draws(video_item(), VIDEO_SHAPE), "video")


def test_node_sweep_on_sp(world):
    """The 5-D sweep (test_torch_video_5d.py) on an sp-sharded 1×4×4×8×8
    latent: every node's block is its unsharded draw's slice, and the five
    nodes that refuse a raw 5-D latent refuse it here too."""
    nodes = noise_nodes()
    assert len(nodes) >= 25 and set(world[0]["sweep"]) == set(nodes)
    for name, item in nodes.items():
        got = world[0]["sweep"][name]
        if name in UNSUPPORTED_5D:
            assert isinstance(got, tuple) and got[0] == "raised", name
            continue
        full = _draws(item, SWEEP_SHAPE)[:1]
        for r in world:
            g = r["sweep"][name]
            assert not (isinstance(g, tuple) and g[0] == "raised"), (name, g)
            _close_rel(g[0], _block(full[0], r["boxes"]["sweep"]))


@pytest.mark.parametrize("mode", ["bilinear", "nearest-exact"])
@pytest.mark.parametrize("layout", list(NOISE_LAYOUTS))
def test_b5_plain_version_draws_planes(world, layout, mode):
    """Kernel B5's plain version with ``planes=``: each rank's planes of the
    unsharded downscale draw, bit for bit (also where a rank's block starts
    inside a Philox group)."""
    shape = NOISE_LAYOUTS[layout]
    h, w = shape[-2:]
    sizes, coefs = {"bilinear": ([(h, w), (3 * h, 3 * w)], [1.0, 0.7]),
                    "nearest-exact": ([(2 * h, 2 * w), (4 * h, 4 * w)], [1.0, 0.4])}[mode]
    planes = math.prod(shape[:-2])
    full = fused_downscale_pyramid(9, (1, planes, h, w), sizes, coefs, mode,
                                   device="cpu").reshape(shape)
    for r in world:
        want = _block(full, r["boxes"][layout]).reshape(r["b5"][(layout, mode)].shape)
        np.testing.assert_array_equal(r["b5"][(layout, mode)], want.numpy())


def test_b5_planes_refuses_a_ragged_run():
    """A plane slice whose run does not divide the field is refused, as B4's."""
    with pytest.raises(ValueError, match="whole runs"):
        fused_downscale_pyramid(9, (1, 3, 8, 8), [(8, 8)], [1.0], "bilinear", device="cpu",
                                planes=(0, 2, 4))


def test_unshardable_items_refused(world):
    """An item that does not say SHARDABLE is refused on a shard, alone and
    inside a chain of shardable items."""
    for r in world:
        for kind, msg in r["refused"]:
            assert kind == "NotImplementedError" and "SHARDABLE" in msg


def test_one_rank_collective_makes_no_call(world):
    """A sum over a 1-rank group (tp of a 4×1 mesh) is the value itself and
    calls no collective; over dp it is one call. all_max and all_min over dp
    are the ranks' extremes."""
    ranks = np.arange(RANKS, dtype=np.float32)
    for r in world:
        n_tp, n_dp, tp_sum, dp_sum, hi, lo = r["one_rank"]
        assert (n_tp, n_dp) == (0, 1)
        np.testing.assert_array_equal(tp_sum, np.arange(3.0) + r["rank"])
        np.testing.assert_array_equal(dp_sum, 4 * np.arange(3.0) + ranks.sum())
        np.testing.assert_array_equal(hi, np.arange(3.0) + RANKS - 1)
        np.testing.assert_array_equal(lo, np.arange(3.0))

