"""Generalized-Collatz chain noise (port of ``sonar_tpu.noise.collatz``;
reference CollatzNoiseGenerator, py/noise_generation.py:2330-2615).

Each iteration draws a seed array (Philox uniforms, kernel B3 on the card,
or the ``seed_noise_sampler`` child), runs the chain recurrence for
``chain_length + chain_offset − 1`` steps and lays the (values, adds, muls)
of every step out chunk-major, step-minor along one dim (the reference's
strided writes). The JAX package's ``lax.scan`` over the static chain length
is a host loop here (at most 7 steps an iteration with the defaults, 58 in
their 10 iterations, about 30 elementwise launches a step), so a draw is a
fixed sequence of launches that reads nothing back: about 1,900 launches a
draw with the defaults (a CPU count), host-bound like the rest of the
algebra.

The chain is exact to the bit of the JAX package's: XLA compiles the scan's
step with its two products-and-sums (``adds·muls + addition·sign`` and
``noise·muls + adds``) contracted into fused multiply-adds, so the port
computes each in float64 (the float32 product is exact there) and rounds
the sum once to float32, which is the fused result; every other operation
is one float32 operation (JAX's float ``%`` is the floor-mod
``torch.remainder``). A one-ulp difference would matter: the values are
truncated to integers whose parity steers the next step, and the values
reach 3⁷ · 8000 ≈ 1.7e7 (past 2²⁴) with the defaults.
"""

from __future__ import annotations

import math

import torch

from ..core.normalize import normalize_to_scale, quantile_normalize
from ..core.rng import derive_seed
from ..kernels.hwrng import philox_rand, philox_randn
from ..utils.misc import default_device, trunc_decimals
from .generators import Generator


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dtype) -> torch.Tensor:
    """``a·b + c`` rounded once to ``dtype`` (float32), as a fused
    multiply-add rounds it: the product of two float32 numbers is exact in
    float64. ``a`` may be given in float64 already."""
    return (a.double() * b.double() + c.double()).to(dtype)


class CollatzGenerator(Generator):
    name = "collatz"

    @classmethod
    def ng_params(cls):
        return super().ng_params() | {
            "adjust_scale": False,
            "iteration_sign_flipping": True,
            "chain_length": (1, 1, 2, 2, 3, 3),
            "iterations": 10,
            "rmin": -8000.0,
            "rmax": 8000.0,
            "flatten": False,
            "dims": (-1, -1, -2, -2),
            "output_mode": "values",
            "quantile": 0.5,
            "quantile_strategy": "clamp",
            "noise_dtype": torch.float32,
            "integer_math": True,
            "even_multiplier": 0.5,
            "even_addition": 0.0,
            "odd_multiplier": 3.0,
            "odd_addition": 1.0,
            "add_preserves_sign": True,
            "chain_offset": 5,
            "break_loops": True,
            "seed_mode": "default",
            "seed_noise_sampler": None,
            "mix_noise_sampler": None,
        }

    def _chain_dims(self, nd: int) -> tuple[int, ...]:
        """The dimensions a chain runs along (the flattened tail with ``flatten``)."""
        dims = {d % nd for d in self.dims}
        return tuple(sorted(set(range(min(dims), nd)) if self.flatten else dims))

    def couples(self, ctx):
        """A chain runs along its dimension: along a split one it would
        cross ranks (and a flattened tail is not a field of the latent's
        planes)."""
        return self.flatten or ctx.splits(self._chain_dims(len(ctx.shape)))

    # -- child plumbing -------------------------------------------------------
    def _children(self):
        return {"seed": self.seed_noise_sampler, "mix": self.mix_noise_sampler}

    def init_state(self, ctx, seed):
        if ctx.shard is not None and self.couples(ctx):
            ctx = ctx.whole()  # the whole latent's draw, as generate makes it
        return {k: (None if c is None else c.init_state(ctx, derive_seed(seed, i)))
                for i, (k, c) in enumerate(self._children().items())}

    # -- one iteration ---------------------------------------------------------
    def _chain(self, noise: torch.Tensor, chain_len_total: int):
        """The generalized-Collatz recurrence: stacked (values, adds, muls)
        with a leading step axis of ``chain_len_total``."""
        emul, eadd = self.even_multiplier, self.even_addition
        omul, oadd = self.odd_multiplier, self.odd_addition
        prev, prev_adds, prev_muls = noise, torch.zeros_like(noise), torch.ones_like(noise)
        vals, adds, muls = [prev], [prev_adds], [prev_muls]
        noise64 = noise.double()
        for _ in range(chain_len_total - 1):
            prev_trunc = trunc_decimals(prev, 2)
            need_reset = None
            if self.break_loops:
                need_reset = (((prev_trunc >= 1.0) & (prev_trunc < 1.001))
                              | (torch.abs(prev_trunc) < 0.001))
            prev_evens = torch.remainder(prev, 2.0) < 1.0
            # a product (or fused sum) of the selected operand: the same bits as
            # selecting between the two products (or fused sums)
            muls_next = prev_muls * torch.where(prev_evens, emul, omul)
            if need_reset is not None:
                muls_next = torch.where(need_reset, 1.0, muls_next)
            addition = torch.where(prev_evens, eadd, oadd)
            if self.add_preserves_sign:
                addition = addition * torch.sign(prev)
            adds_next = _fma(prev_adds, muls_next, addition, noise.dtype)
            if need_reset is not None:
                adds_next = torch.where(need_reset, 0.0, adds_next)
            result_next = _fma(noise64, muls_next, adds_next, noise.dtype)
            if self.integer_math:
                result_next = torch.trunc(result_next)
            if need_reset is not None:
                result_next = torch.where(need_reset, noise, result_next)
            prev, prev_adds, prev_muls = result_next, adds_next, muls_next
            vals.append(prev)
            adds.append(prev_adds)
            muls.append(prev_muls)
        return torch.stack(vals), torch.stack(adds), torch.stack(muls)

    @staticmethod
    def _interleave(stacked: torch.Tensor, dim: int) -> torch.Tensor:
        """(CL, ..., n_chunks@dim, ...) → (..., n_chunks*CL@dim, ...),
        chunk-major step-minor: the reference's strided-write layout."""
        moved = torch.movedim(stacked, 0, dim + 1)  # step axis right after dim
        shape = moved.shape
        return moved.reshape(shape[:dim] + (shape[dim] * shape[dim + 1],) + shape[dim + 2:])

    def _generate_iteration(self, ctx, state, seed, sigma, sigma_next, *, dim, chain_length):
        device = default_device(ctx.device)
        shape = tuple(ctx.shape)
        out_shape = shape
        if self.flatten:
            shape = shape[:dim] + (math.prod(shape[dim:]),)
        size = shape[dim]
        chain_length = min(size, chain_length)
        n_chunks = math.ceil(size / chain_length)
        cl_total = chain_length + self.chain_offset
        chunk_shape = shape[:dim] + (n_chunks,) + shape[dim + 1:]

        sseed, smix = derive_seed(seed, 0), derive_seed(seed, 1)
        if self.seed_noise_sampler is not None:
            seed_full, st = self.seed_noise_sampler.sample(ctx, state["seed"], sseed, sigma,
                                                           sigma_next, normalized=False)
            state = {**state, "seed": st}
            if self.flatten:
                seed_full = seed_full.reshape(seed_full.shape[:dim]
                                              + (math.prod(seed_full.shape[dim:]),))
            sl = tuple(slice(None, sz) for sz in chunk_shape)
            # per sample: across the ranks where a sample is split
            orig_noise = ctx.across(
                range(1, len(chunk_shape)),
                lambda v: normalize_to_scale(v, 1e-06, 1.0,
                                             dim=tuple(range(1, len(chunk_shape)))),
                seed_full[sl].contiguous())
        else:
            kw = {} if ctx.shard is None else {"shard": ctx.field_shard(chunk_shape)}
            orig_noise = philox_rand(sseed, chunk_shape, device=device, dtype=self.noise_dtype,
                                     **kw)
        rmin, rmax = self.rmin, self.rmax
        noise = orig_noise.to(self.noise_dtype) * (rmax - rmin + 1) + rmin
        # the whole latent's largest value over its element count
        total = noise.numel() if ctx.shard is None else math.prod(ctx.global_shape(noise.shape))
        noise = torch.where(noise == 0, ctx.pmax(torch.amax(noise)) / total, noise)
        if self.seed_mode != "default":
            even = torch.remainder(noise, 2.0) < 1
            noise = torch.where(even if self.seed_mode == "force_odd" else ~even, noise + 1, noise)

        vals, adds, muls = self._chain(noise, cl_total)
        omode = self.output_mode
        noise_exp = torch.repeat_interleave(noise, cl_total, dim=dim)
        if omode in {"values", "ratios", "seed_x_ratios", "noise_x_ratios"}:
            out1 = self._interleave(vals, dim) / noise_exp
        elif omode in {"mults", "seed_x_mults", "noise_x_mults"}:
            out1 = self._interleave(muls, dim)
        elif omode in {"adds", "seed_x_adds", "noise_x_adds"}:
            out1 = self._interleave(adds, dim) / noise_exp
        else:
            raise ValueError("Bad output mode")
        # trim the chain_offset warm-up from every chunk
        if self.chain_offset >= 1:
            s = out1.shape
            grouped = out1.reshape(s[:dim] + (n_chunks, cl_total) + s[dim + 1:])
            grouped = grouped.narrow(dim + 1, self.chain_offset, chain_length)
            out1 = grouped.reshape(s[:dim] + (n_chunks * chain_length,) + s[dim + 1:])
        if self.quantile not in {0, 1}:  # dim 0 flattened: the whole latent's quantile
            out1 = ctx.on_whole(lambda v: quantile_normalize(
                v, quantile=self.quantile, dim=0, strategy=self.quantile_strategy), out1)
        output_slice = tuple(slice(None, sz) for sz in shape)
        out1 = out1[output_slice].reshape(out_shape).to(ctx.dtype)
        if omode in {"ratios", "mults", "adds"}:
            return out1, state
        if omode in {"values", "seed_x_ratios", "seed_x_mults", "seed_x_adds"}:
            out2 = torch.repeat_interleave(orig_noise, chain_length, dim=dim)
        elif self.mix_noise_sampler is None:
            kw = {} if ctx.shard is None else {"shard": ctx.field_shard(shape)}
            out2 = philox_randn(smix, shape, device=device, dtype=out1.dtype, **kw)
        else:
            out2, st = self.mix_noise_sampler.sample(ctx, state["mix"], smix, sigma, sigma_next,
                                                     normalized=False)
            state = {**state, "mix": st}
            if self.flatten:
                out2 = out2.reshape(out2.shape[:dim] + (-1,))
        out2 = out2[output_slice].reshape(out_shape).to(ctx.dtype)
        return out2 * out1, state

    def generate(self, ctx, state, seed, sigma, sigma_next):
        out_dims = len(ctx.shape)
        dims = tuple(d if d >= 0 else out_dims + d for d in self.dims)
        if not all(0 <= d < out_dims for d in dims):
            raise ValueError("Dimension out of range")
        n_dims, n_cl = len(dims), len(self.chain_length)
        result = torch.zeros(ctx.shape, dtype=ctx.dtype, device=default_device(ctx.device))
        it_scale = 1.0 / self.iterations
        for it in range(self.iterations):
            temp, state = self._generate_iteration(
                ctx, state, derive_seed(seed, it), sigma, sigma_next,
                dim=dims[it % n_dims], chain_length=self.chain_length[it % n_cl])
            sign = -1.0 if self.iteration_sign_flipping and (it & 1) == 1 else 1.0
            result = result + temp * (it_scale * sign)
        if self.adjust_scale:
            dims = tuple(range(1 if result.ndim < 4 else 2, result.ndim))
            result = ctx.across(dims, lambda v: normalize_to_scale(v, -1.0, 1.0, dim=dims),
                                result)
        return result, state


__all__ = ["CollatzGenerator"]
