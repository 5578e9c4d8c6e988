"""The weights of a run, made on the device from ``--seed``: one normal draw
of every weight's elements at once by a generator of that device, then each
weight scaled and shifted to its family's ``(mean, std)`` (one fused call
each for all weights). The same seed gives the same tensors, so the program
and the reference each get their own copy of the same values."""

from __future__ import annotations

import math

import torch

from .reference.philox import derive_seed


def make(specs, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``specs`` = ``[(name, shape, mean, std), ...]``:
    views of one flat buffer, each contiguous."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights") & ((1 << 63) - 1))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    views = [v.view(shape) for v, (_, shape, _, _) in zip(flat.split(sizes), specs)]
    torch._foreach_mul_(views, [float(std) for _, _, _, std in specs])
    torch._foreach_add_(views, [float(mean) for _, _, mean, _ in specs])
    return {name: v for v, (name, _, _, _) in zip(views, specs)}
