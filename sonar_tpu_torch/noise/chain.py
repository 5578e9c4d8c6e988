"""Noise chain (port of ``sonar_tpu.noise.chain``): sums its items drawn
unnormalized, then normalizes once at the chain's factor
(py/noise.py:137-196). Under a sharded latent it draws a rank's block when
each of its items can."""

from __future__ import annotations

from ..core.normalize import scale_noise
from ..core.rng import derive_seed
from .base import NoiseItem


class NoiseChain(NoiseItem):
    def __init__(self, items=None, *, normalize: bool | None = None):
        super().__init__(1.0, normalize=normalize, items=list(items or ()))

    def clone(self):
        return NoiseChain([i.clone() for i in self.items], normalize=self.normalize)

    def add(self, item: NoiseItem):
        if item is None:
            raise ValueError("Attempt to add nil item")
        self.items.append(item)
        return self

    # each item draws its block and the sum is normalized with the whole
    # latent's statistics (``make_noise_sampler`` checks the items too)
    SHARDABLE = True

    @property
    def chain_factor(self) -> float:
        # Σ|item.factor| — py/noise.py:151-153
        return sum(abs(i.factor) for i in self.items)

    def rescaled(self, scale: float = 1.0) -> "NoiseChain":
        divisor = self.chain_factor / scale
        divisor = divisor if divisor != 0 else 1.0
        result = self.clone()
        if divisor != 1:
            for i in result.items:
                i.set_factor(i.factor / divisor)
        return result

    def check_dims(self, ctx):
        if not self.items:
            raise ValueError("Empty noise chain")
        for i in self.items:
            i.check_dims(ctx)

    def init_state(self, ctx, seed):
        return tuple(item.init_state(ctx, derive_seed(seed, i))
                     for i, item in enumerate(self.items))

    def sample(self, ctx, state, seed, sigma, sigma_next, *, normalized=True):
        result = None
        new_states = []
        for i, item in enumerate(self.items):
            noise, st = item.sample(ctx, state[i], derive_seed(seed, i), sigma, sigma_next,
                                    normalized=False)
            new_states.append(st)
            result = noise if result is None else result + noise
        eff = self.normalize if self.normalize is not None else normalized
        result = scale_noise(result, self.chain_factor, normalized=bool(eff), shard=ctx.shard)
        return result, tuple(new_states)
