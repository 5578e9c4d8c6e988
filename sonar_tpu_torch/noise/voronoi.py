"""3D toroidal Worley/Voronoi noise (port of ``sonar_tpu.noise.voronoi``;
reference VoronoiNoiseGenerator, py/noise_generation.py:1291-1904).

Feature points and the z-depth walk are explicit state: per-octave-group
feature points, ``z`` and ``zinc``. The z-max reset/bounce/wrap policies are
``torch.where`` selects on device tensors, so no draw waits for the card.

The ``name:arg=val`` + ``+``-averaged mode mini-language
(py/noise_generation.py:1780-1845) is parsed on the host. All distance and
result modes are here, including the reference's ``manhatten`` quirk (it
computes euclidean, py/noise_generation.py:1483-1485).

Three routes to the distances, as in the JAX package:

- **kernel B6** (:func:`~sonar_tpu_torch.kernels.voronoi.voronoi_ksmallest`)
  when :meth:`VoronoiGenerator._kernel_plan` holds: float32, one simple
  distance with ``dscale > 0``, result modes that read only a sorted prefix
  of 1 to 8 distances (f1, the default, included). On a CPU tensor the
  wrapper runs its plain version;
- the per-axis path for a simple distance: the (B, C, H, W, N) tensor built
  axis by axis, then the k smallest by ``torch.topk``;
- the generic path over the (B, C, H, W, N, 3) wrapped differences.

The JAX package keeps a prefix of one (f1) on the per-axis path, where on
the TPU one fused min beat its kernel's point loop (voronoi.py:500-503
there). On this card the kernel is the faster route for every prefix, so f1
takes it too; its values are the per-axis path's bit for bit (minkowski
to an ulp of ``pow``).

Seeds: every ``fold_in``/``split`` of the JAX package is a
:func:`~sonar_tpu_torch.core.rng.derive_seed` label of its own; feature
points are Philox uniforms (kernel B3), so one seed gives the same points on
the CPU and the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.normalize import normalize_to_scale, tmedian
from ..core.rng import derive_seed
from ..kernels.hwrng import philox_rand
from ..kernels.voronoi import sqrt_rn, voronoi_kernel_supported, voronoi_ksmallest
from ..utils.misc import fallback
from .generators import Generator, _device


def _parse_modes(spec: str, scale_key: str):
    """'a:x=1+b:y=2' → [(name, kwargs, scale)] with 1/len averaging."""
    modes = spec.split("+")
    base = 1.0 / len(modes)
    out = []
    for mode in modes:
        if ":" in mode:
            name, *rest = mode.split(":")
            kw = dict(tuple(v.strip() for v in item.split("=", 1)) for item in rest)
            scale = base * float(kw.pop(scale_key, 1.0))
        else:
            name, kw, scale = mode, {}, base
        kw = {k[1:] if k.startswith("_") and len(k) > 1 else k: v for k, v in kw.items()}
        out.append((name.strip().lower(), kw, scale))
    return out


_FIXED_PREFIX = {"f1": 1, "f2": 2, "f3": 3, "f4": 4,
                 "inv_f1": 1, "inv_f2": 2, "inv_f3": 3, "inv_f4": 4,
                 "cellid": 0, "fractal_norm": 0}


def _mode_prefix(name, kw):
    """How many smallest distances a result mode reads from env["sorted"]
    (None = needs the full sort)."""
    if name in _FIXED_PREFIX:
        return _FIXED_PREFIX[name]
    if name in ("f", "inv_f"):
        idx = int(kw.get("idx", 0))
        # a negative idx indexes from the end of the sorted distances
        return None if idx < 0 else idx + 1
    if name in ("diff", "diff2"):
        i1, i2 = int(kw.get("idx1", 0)), int(kw.get("idx2", 1))
        return None if i1 < 0 or i2 < 0 else max(i1, i2) + 1
    if name == "ridge":
        return _mode_prefix(kw.get("name", "diff"), kw)
    if name == "fuzz":
        return _mode_prefix(kw.get("name", "f1"), kw)
    if name == "gradient_magnitude":
        a = _mode_prefix(kw.get("name1", "f4"), kw)
        b = _mode_prefix(kw.get("name2", "f4"), kw)
        return None if a is None or b is None else max(a, b)
    if name == "softmin":
        return None if kw.get("use_sorted") is not None else 0
    return None  # median_distance / unknown: full sort


def _sorted_prefix(parsed):
    """Combined prefix requirement of a parsed `+`-composed mode list."""
    k = 0
    for name, kw, _scale in parsed:
        mk = _mode_prefix(name, kw)
        if mk is None:
            return None
        k = max(k, mk)
    return k


def _sorted_small(d, k):
    """Ascending distances along the last axis: the k-smallest prefix when
    only a prefix is read (a min for one, ``torch.topk`` otherwise), else
    the full sort. Values equal the sort's prefix; tie order may differ,
    which no consumer observes."""
    if k is not None and 0 < k < d.shape[-1]:
        if k == 1:
            return torch.amin(d, dim=-1, keepdim=True)
        return torch.topk(d, k, dim=-1, largest=False, sorted=True).values
    return torch.sort(d, dim=-1).values


def _normalize_vec(d, dim=-1, eps=1e-12):
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=dim, keepdim=True), min=eps)


# result modes that read only env["sorted"] / env["key"] (never d or
# d_orig): the surface the kernel can serve directly
_SORTED_ONLY = {"f", "f1", "f2", "f3", "f4",
                "inv_f", "inv_f1", "inv_f2", "inv_f3", "inv_f4",
                "diff", "diff2"}


def _result_sorted_only(name, kw) -> bool:
    if name in _SORTED_ONLY:
        return True
    if name == "ridge":
        return _result_sorted_only(kw.get("name", "diff"), kw)
    if name == "fuzz":
        return _result_sorted_only(kw.get("name", "f1"), kw)
    if name == "gradient_magnitude":
        return (_result_sorted_only(kw.get("name1", "f4"), kw)
                and _result_sorted_only(kw.get("name2", "f4"), kw))
    return False


# distance modes expressible as a per-axis reduction over wrapped diffs
# (the manhatten quirk IS euclidean — py/noise_generation.py:1483)
_AXIS_DISTS = {"euclidean", "manhatten", "quadratic", "chebyshev", "minkowski"}


def _simple_distance(parsed):
    """(dist, p, weights, dscale) for a single simple (optionally
    weight-wrapped) distance spec, else None. Covers the per-axis path and
    the kernel's distance surface."""
    if len(parsed) != 1:
        return None
    name, kw, dscale = parsed[0]
    weights = None
    if name == "weight":
        kw = dict(kw)
        name = kw.pop("name", "euclidean")
        weights = (float(kw.pop("h", 1.0)), float(kw.pop("w", 1.0)),
                   float(kw.pop("z", 0.25)))
    if name not in _AXIS_DISTS:
        return None
    if name == "manhatten":
        name = "euclidean"
    p = float(kw.get("p", 3.0)) if name == "minkowski" else 3.0
    return name, p, weights, dscale


class VoronoiGenerator(Generator):
    name = "voronoi"
    MIN_DIMS = 4
    MAX_DIMS = 4
    # the reference overrides the base default to normalized=False
    # (py/noise_generation.py:1352): raw distance fields keep their scale
    # inside compositions (voronoi_mix sums raw voronoi x0.6 + raw gaussian
    # x0.4 and normalizes once at the wrap)
    DEFAULT_NORMALIZED = False

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "n_points": (32,),
            "distance_mode": ("euclidean",),
            "z_initial": 0.0,
            "z_increment": 1.0,
            "z_max": 100000,
            "z_max_mode": "reset",
            "z_range": None,
            "result_mode": ("f1",),
            "octaves": 1,
            "octave_mode": "same_features",
            "lacunarity": 2.0,
            "gain": 0.5,
            "initial_amplitude": 1.0,
            "initial_scale": 1.0,
            "noise_sampler_factory": None,
        }

    # -- feature-point state ----------------------------------------------------

    def _octave_groups(self) -> int:
        return self.octaves if self.octave_mode == "new_features" else 1

    def _npoints(self, group: int) -> int:
        pts = tuple(max(2, v) for v in self.n_points)
        return pts[group % len(pts)]

    def _draw_feature_points(self, ctx, state, seed, sigma, sigma_next):
        """Fresh feature points per octave group, uniform or from the
        injected factory normalized to [0, 1] (py/noise_generation.py:1367-1404)."""
        fps = []
        for g in range(self._octave_groups()):
            shape = (ctx.batch, ctx.channels, self._npoints(g), 3)
            sg = derive_seed(seed, "group", g)
            if self.noise_sampler_factory is None:
                fps.append(self.rand(ctx, sg, shape))
            else:
                fctx = ctx.with_shape(shape)
                n, st = self.noise_sampler_factory.sample(
                    fctx, state["factory"][g], sg, sigma, sigma_next, normalized=False)
                state = {**state,
                         "factory": state["factory"][:g] + (st,) + state["factory"][g + 1:]}
                fps.append(normalize_to_scale(n, 0.0, 1.0, dim=(-1, -2)))
        return tuple(fps), state

    def init_state(self, ctx, seed):
        state = {}
        if self.noise_sampler_factory is not None:
            state["factory"] = tuple(
                self.noise_sampler_factory.init_state(
                    ctx.with_shape((ctx.batch, ctx.channels, self._npoints(g), 3)),
                    derive_seed(seed, "factory", g))
                for g in range(self._octave_groups())
            )
        fps, state = self._draw_feature_points(ctx, state, seed, None, None)
        state["fp"] = fps
        dev = _device(ctx)
        state["z"] = torch.tensor(float(self.z_initial), dtype=ctx.dtype, device=dev)
        state["zinc"] = torch.tensor(float(self.z_increment), dtype=ctx.dtype, device=dev)
        return state

    def _feature_points(self, state, octave: int):
        """Octave-mode transformed feature points (py/noise_generation.py:
        1427-1447)."""
        fp = state["fp"][octave % len(state["fp"])]
        odd = (octave % 2) == 1
        om = self.octave_mode
        if (om == "same_invert_odd" and odd) or (om == "same_invert_even" and not odd):
            return 1.0 - fp
        if octave > 0 and om in {"same_roll_chan_up", "same_roll_chan_down"}:
            return torch.roll(fp, (-1 if om.endswith("up") else 1) * (octave % 3), dims=1)
        if octave > 0 and om in {"same_roll_dir_up", "same_roll_dir_down"}:
            return torch.roll(fp, (-1 if om.endswith("up") else 1) * (octave % 3), dims=3)
        return fp

    # -- distance modes ----------------------------------------------------------

    def _dist(self, name, d, kw, seed):
        fn = getattr(self, f"_distance_{name}", None)
        if fn is None:
            raise ValueError(f"Bad Voronoi distance mode {name}")
        return fn(d, kw, seed)

    def _distance_euclidean(self, d, kw, seed):
        return torch.sqrt(torch.sum(d * d, dim=-1))

    # reference quirk: manhatten computes euclidean (py/noise_generation.py:1483)
    _distance_manhatten = _distance_euclidean

    def _distance_chebyshev(self, d, kw, seed):
        return torch.amax(torch.abs(d), dim=-1)

    def _distance_minkowski(self, d, kw, seed):
        p = float(kw.get("p", 3.0))
        return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)

    def _distance_quadratic(self, d, kw, seed):
        return torch.sum(d * d, dim=-1)

    def _distance_angle(self, d, kw, seed):
        idx = int(kw.get("idx", 2))
        return torch.arccos(torch.clamp(_normalize_vec(d)[..., idx], -1.0, 1.0))

    def _distance_angle_tanh(self, d, kw, seed):
        idx = int(kw.get("idx", 2))
        return torch.arccos(torch.tanh(_normalize_vec(d)[..., idx]))

    def _distance_angle_sigmoid(self, d, kw, seed):
        idx = int(kw.get("idx", 2))
        return torch.arccos(torch.sigmoid(_normalize_vec(d)[..., idx]) * 2.0 - 1.0)

    def _distance_weight(self, d, kw, seed):
        kw = dict(kw)
        name = kw.pop("name", "euclidean")
        weights = torch.tensor(
            (float(kw.pop("h", 1.0)), float(kw.pop("w", 1.0)), float(kw.pop("z", 0.25))),
            dtype=d.dtype, device=d.device,
        )
        return self._dist(name, d * weights, kw, seed)

    def _distance_fractal_norm(self, d, kw, seed):
        kw = dict(kw)
        name = kw.pop("name", "euclidean")
        mode = kw.pop("mode", "sin")
        if mode not in ("sin", "cos"):
            raise ValueError(
                "Bad mode parameter for fractal_norm distance mode, must be one of: sin, cos"
            )
        fun = torch.sin if mode == "sin" else torch.cos
        adj = float(kw.pop("scale", 0.1)) * fun(d * float(kw.pop("multiplier", 10.0)))
        return self._dist(name, d + adj, kw, seed)

    def _fuzzed(self, result, fuzz: float, seed):
        """result + U(-1, 1)·max(|min|, |max|)·fuzz, remapped to the
        unfuzzed [min, max] over the last two axes."""
        rmin, rmax = torch.min(result), torch.max(result)
        amt = torch.maximum(torch.abs(rmin), torch.abs(rmax)) * fuzz
        u = philox_rand(seed, result.shape, device=result.device, dtype=result.dtype)
        result = result + (u * 2 - 1) * amt
        return normalize_to_scale(result, rmin, rmax, dim=(-2, -1))

    def _distance_fuzz(self, d, kw, seed):
        kw = dict(kw)
        name = kw.pop("name", "euclidean")
        fuzz = float(kw.pop("fuzz", 0.25))
        result = self._dist(name, d, kw, derive_seed(seed, "inner"))
        return self._fuzzed(result, fuzz, derive_seed(seed, "fuzz"))

    # -- result modes --------------------------------------------------------------

    def _res(self, name, d, env, kw):
        fn = getattr(self, f"_result_{name}", None)
        if fn is None:
            raise ValueError(f"Bad Voronoi result mode {name}")
        return fn(d, env, kw)

    def _result_f(self, d, env, kw):
        return env["sorted"]()[..., int(kw.get("idx", 0))]

    def _result_f1(self, d, env, kw):
        return env["sorted"]()[..., 0]

    def _result_f2(self, d, env, kw):
        return env["sorted"]()[..., 1]

    def _result_f3(self, d, env, kw):
        return env["sorted"]()[..., 2]

    def _result_f4(self, d, env, kw):
        return env["sorted"]()[..., 3]

    def _result_inv_f(self, d, env, kw):
        eps = float(kw.get("eps", 1e-06))
        return 1.0 / (self._result_f(d, env, kw) + eps)

    def _result_inv_f1(self, d, env, kw):
        return self._result_inv_f(d, env, {**kw, "idx": 0})

    def _result_inv_f2(self, d, env, kw):
        return self._result_inv_f(d, env, {**kw, "idx": 1})

    def _result_inv_f3(self, d, env, kw):
        return self._result_inv_f(d, env, {**kw, "idx": 2})

    def _result_inv_f4(self, d, env, kw):
        return self._result_inv_f(d, env, {**kw, "idx": 3})

    def _result_diff(self, d, env, kw):
        i1, i2 = int(kw.get("idx1", 0)), int(kw.get("idx2", 1))
        s = env["sorted"]()
        return s[..., i2] - s[..., i1]

    def _result_diff2(self, d, env, kw):
        i1, i2 = int(kw.get("idx1", 0)), int(kw.get("idx2", 1))
        s = env["sorted"]()
        return (s[..., i2] - s[..., i1]) / (s[..., i2] + s[..., i1] + 1e-06)

    def _result_cellid(self, d, env, kw):
        ids = torch.argmin(d, dim=-1).to(d.dtype)
        return ids / torch.max(ids) + 1.0

    def _result_ridge(self, d, env, kw):
        kw = dict(kw)
        name = kw.pop("name", "diff")
        exp = float(kw.pop("exp", -10.0))
        return 1.0 - exp * self._res(name, d, env, kw)

    def _result_median_distance(self, d, env, kw):
        return tmedian(env["sorted"](), axis=-1)

    def _result_softmin(self, d, env, kw):
        temperature = float(kw.get("temperature", 50.0))
        d_norm = torch.linalg.vector_norm(env["d_orig"], dim=-1)
        w = torch.softmax(-d_norm * temperature, dim=-1)
        eff = env["sorted"]() if kw.get("use_sorted") is not None else d
        return torch.sum(eff * w, dim=-1)

    def _result_gradient_magnitude(self, d, env, kw):
        kw = dict(kw)
        name1 = kw.pop("name1", "f4")
        name2 = kw.pop("name2", "f4")
        mode = kw.pop("pad_mode", "replicate")  # torch's names are the reference's
        r1p = F.pad(self._res(name1, d, env, kw), (1, 1, 1, 1), mode=mode)
        if name2 != name1:
            r2p = F.pad(self._res(name2, d, env, kw), (1, 1, 1, 1), mode=mode)
        else:
            r2p = r1p
        dx = r1p[..., 1:-1, 2:] - r2p[..., 1:-1, :-2]
        dy = r1p[..., 2:, 1:-1] - r2p[..., :-2, 1:-1]
        return torch.sqrt(dx**2 + dy**2)

    def _result_fractal_norm(self, d, env, kw):
        kw = dict(kw)
        name = kw.pop("name", "diff")
        mode = kw.pop("mode", "sin")
        if mode not in ("sin", "cos"):
            raise ValueError(
                "Bad mode parameter for fractal_norm result mode, must be one of: sin, cos"
            )
        fun = torch.sin if mode == "sin" else torch.cos
        d_adj = float(kw.pop("scale", 0.1)) * fun(d * float(kw.pop("multiplier", 10.0)))
        cache = {}
        k = _mode_prefix(name, kw)

        def my_sorted():
            if "s" not in cache:
                cache["s"] = _sorted_small(d_adj, k)
            return cache["s"]

        return self._res(name, d_adj, {**env, "sorted": my_sorted}, kw)

    def _result_fuzz(self, d, env, kw):
        kw = dict(kw)
        name = kw.pop("name", "f1")
        fuzz = float(kw.pop("fuzz", 0.25))
        result = self._res(name, d, env, kw)
        return self._fuzzed(result, fuzz, env["seed"])

    # -- octave + main loop ----------------------------------------------------------

    def _apply_distance(self, d, octave, seed):
        spec = self.distance_mode[octave % len(self.distance_mode)]
        result = None
        for i, (name, kw, scale) in enumerate(_parse_modes(spec, "dscale")):
            cur = self._dist(name, d, kw, derive_seed(seed, i)) * scale
            result = cur if result is None else result + cur
        return result

    def _apply_result(self, d, d_orig, octave, seed, sorted_override=None):
        spec = self.result_mode[octave % len(self.result_mode)]
        cache = {}
        k = _sorted_prefix(_parse_modes(spec, "rscale"))

        def get_sorted():
            if sorted_override is not None:
                return sorted_override
            if "s" not in cache:
                cache["s"] = _sorted_small(d, k)
            return cache["s"]

        env = {"d_orig": d_orig, "sorted": get_sorted}
        result = None
        for i, (name, kw, scale) in enumerate(_parse_modes(spec, "rscale")):
            cur = self._res(name, d, {**env, "seed": derive_seed(seed, i)}, kw) * scale
            result = cur if result is None else result + cur
        return result

    def _kernel_plan(self, ctx, octave: int, h: int, w: int):
        """(dist, p, weights, dscale, k) when kernel B6 serves this octave's
        (distance, result) spec pair, else None. A function of the
        configuration alone: the device picks kernel or plain version
        inside :func:`voronoi_ksmallest`."""
        if ctx.dtype != torch.float32:
            return None
        dspec = self.distance_mode[octave % len(self.distance_mode)]
        simple = _simple_distance(_parse_modes(dspec, "dscale"))
        if simple is None or simple[3] <= 0:  # sorting needs dscale > 0
            return None
        parsed_r = _parse_modes(self.result_mode[octave % len(self.result_mode)], "rscale")
        if not all(_result_sorted_only(n, kw) for n, kw, _ in parsed_r):
            return None
        k = _sorted_prefix(parsed_r)
        npts = self._npoints(octave % self._octave_groups())
        if k is None or not voronoi_kernel_supported(
                h, w, k, simple[0], ctx.batch * ctx.channels, npts):
            return None
        return simple + (k,)

    def _axis_distance(self, simple, grid3d, fp, scale):
        """Distance tensor (B, C, H, W, N) accumulated per axis; the
        (B, C, H, W, N, 3) wrapped-diff tensor never exists. Same elementwise
        operations as the generic path, so the values are identical."""
        dist, p, weights, dscale = simple

        def axis(a):
            g = (grid3d[..., a] * scale) % 1.0  # (H, W)
            f = (fp[..., a] * scale) % 1.0  # (B, C, N)
            d = (g[None, None, :, :, None] - f[:, :, None, None, :] + 0.5) % 1.0 - 0.5
            return d * weights[a] if weights is not None else d

        if dist == "euclidean":
            d = sqrt_rn(axis(0) ** 2 + axis(1) ** 2 + axis(2) ** 2)
        elif dist == "quadratic":
            d = axis(0) ** 2 + axis(1) ** 2 + axis(2) ** 2
        elif dist == "chebyshev":
            d = torch.maximum(torch.maximum(torch.abs(axis(0)), torch.abs(axis(1))),
                              torch.abs(axis(2)))
        else:  # minkowski
            d = (torch.abs(axis(0)) ** p + torch.abs(axis(1)) ** p
                 + torch.abs(axis(2)) ** p) ** (1.0 / p)
        return d * dscale if dscale != 1.0 else d

    def _octave(self, ctx, state, seed, octave: int, grid3d, scale: float):
        fp = self._feature_points(state, octave)  # (B, C, N, 3)
        sd, sr = derive_seed(seed, "distance"), derive_seed(seed, "result")
        h, w = grid3d.shape[0], grid3d.shape[1]

        plan = self._kernel_plan(ctx, octave, h, w)
        if plan is not None:
            dist, p, weights, dscale, k = plan
            prefix = voronoi_ksmallest(
                fp, grid3d[:, 0, 0], grid3d[0, :, 1], grid3d[0, 0, 2],
                scale=scale, k=k, dist=dist, p=p, weights=weights or (1.0, 1.0, 1.0))
            if dscale != 1.0:
                prefix = prefix * dscale
            return self._apply_result(None, None, octave, sr, sorted_override=prefix)

        dspec = self.distance_mode[octave % len(self.distance_mode)]
        simple = _simple_distance(_parse_modes(dspec, "dscale"))
        rspec = self.result_mode[octave % len(self.result_mode)]
        if simple is not None and "softmin" not in rspec:
            # per-axis path (softmin is the one consumer of the full
            # wrapped-diff tensor d_orig)
            d = self._axis_distance(simple, grid3d, fp, scale)
            return self._apply_result(d, None, octave, sr)

        g = (grid3d[None, None, :, :, None, :] * scale) % 1.0  # (1,1,H,W,1,3)
        f = (fp[:, :, None, None, :, :] * scale) % 1.0  # (B,C,1,1,N,3)
        d_orig = (g - f + 0.5) % 1.0 - 0.5  # toroidal wrap, [-0.5, 0.5)
        d = self._apply_distance(d_orig, octave, sd)
        return self._apply_result(d, d_orig, octave, sr)

    def generate(self, ctx, state, seed, sigma, sigma_next):
        h, w = ctx.height, ctx.width
        dev = _device(ctx)
        # z-max policy (py/noise_generation.py:1871-1884); the reference's
        # "wrap" branch assigns a typo'd attribute (self.curr_z) making it a
        # no-op — implemented correctly here, as in the JAX package.
        z, zinc = state["z"], state["zinc"]
        over = (torch.abs(self.z_initial - z) > abs(self.z_max)) | (self.z_max == 0)
        if self.z_max_mode == "reset":
            fresh, state = self._draw_feature_points(
                ctx, state, derive_seed(seed, "points"), sigma, sigma_next)
            state = {**state, "fp": tuple(
                torch.where(over, f_new, f_old) for f_new, f_old in zip(fresh, state["fp"])
            )}
            z = torch.where(over, torch.full_like(z, float(self.z_initial)), z)
        elif self.z_max_mode == "bounce":
            zinc = torch.where(over, -zinc, zinc)
            z = torch.where(over, z + zinc, z)
        else:  # wrap
            z = torch.where(over, torch.full_like(z, float(self.z_initial)), z)
        z_range = fallback(self.z_range, max(h, w))
        z_norm = (z % z_range) / z_range
        state = {**state, "z": z + zinc, "zinc": zinc}

        ys = torch.arange(h, dtype=torch.float32, device=dev).to(ctx.dtype) / h
        xs = torch.arange(w, dtype=torch.float32, device=dev).to(ctx.dtype) / w
        grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
        grid3d = torch.cat([grid, z_norm.to(ctx.dtype).expand(h, w, 1)], dim=-1)

        result = torch.zeros(ctx.shape, dtype=ctx.dtype, device=dev)
        amplitude = self.initial_amplitude
        scale = self.initial_scale
        total = 0.0
        rest = derive_seed(seed, "octaves")
        for octave in range(self.octaves):
            out = self._octave(ctx, state, derive_seed(rest, octave), octave, grid3d, scale)
            result = result + out * amplitude
            total += abs(amplitude)
            amplitude *= self.gain
            scale *= self.lacunarity
        return result / (total if total != 0 else 1.0), state
