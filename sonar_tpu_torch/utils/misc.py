"""Misc utilities (port of ``sonar_tpu.utils.misc``; reference
py/utils.py). Ported so far: the two the Voronoi generator uses, and the
port's default-device rule."""

from __future__ import annotations

import torch


def fallback(val, default=None):
    return val if val is not None else default


def maybe_apply(val, cond, fun):
    return fun(val) if cond else val


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the one it was given, else the
    card. ``None`` never means the CPU: without a CUDA device the first
    allocation raises torch's own error. A caller that wants the CPU says
    ``device="cpu"``."""
    return torch.device("cuda" if device is None else device)
