"""Small helpers (port of ``sonar_tpu.utils``). Ported so far: ``fallback``
and ``maybe_apply`` of ``utils/misc.py``."""

from .misc import fallback, maybe_apply

__all__ = ["fallback", "maybe_apply"]
