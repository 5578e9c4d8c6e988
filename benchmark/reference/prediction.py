"""What the network sees, by what its output means, as ComfyUI's
``model_sampling.py`` states it: ``eps`` sees ``x/√(σ²+1)`` and ``const``,
the rectified-flow velocity, sees ``x``; both give ``denoised = x − σ·out``.
``sigma`` is a number or a tensor that broadcasts against ``x``."""

from __future__ import annotations

import math

import torch


def network_input(prediction: str, x: torch.Tensor, sigma) -> torch.Tensor:
    if prediction == "const":
        return x
    if prediction == "eps":
        if torch.is_tensor(sigma):
            return x / torch.sqrt(sigma * sigma + 1.0)
        return x / math.sqrt(sigma * sigma + 1.0)
    raise ValueError(f"prediction {prediction!r}: 'eps' or 'const'")
