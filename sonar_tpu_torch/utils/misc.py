"""Misc utilities (port of ``sonar_tpu.utils.misc``; reference
py/utils.py). Ported so far: the two the Voronoi generator uses."""

from __future__ import annotations


def fallback(val, default=None):
    return val if val is not None else default


def maybe_apply(val, cond, fun):
    return fun(val) if cond else val
