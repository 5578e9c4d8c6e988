"""Structural equality of a built object of the port and of the JAX package
(``tests/test_torch_nodes.py``, ``tests/test_torch_api_misc.py``): the same
class names through the whole tree, parameters equal field by field
(arrays within 1e-6, floats within 1e-6 relative, functions by name, dtypes
by name, enums by value)."""

import enum
import functools
import math

import jax
import numpy as np
import pytest
import torch


def dtype_name(d):
    return str(d).replace("torch.", "").replace("<class 'jax.numpy.", "").rstrip("'>")


def _is_array(v):
    return isinstance(v, (np.ndarray, jax.Array, torch.Tensor))


def same(j, t, path="node", seen=None, skip=None):
    """Hold the port's built object ``t`` against the JAX package's ``j``;
    ``skip`` maps a class name to parameters not compared."""
    seen = set() if seen is None else seen
    skip = skip or {}
    if id(t) in seen:
        return
    if _is_array(j) or _is_array(t):
        a = np.asarray(j)
        b = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=path)
        return
    if isinstance(t, torch.dtype):  # jnp takes a dtype or its name
        assert dtype_name(j) == dtype_name(t), path
        return
    if isinstance(j, float) or isinstance(t, float):
        assert (math.isnan(j) and math.isnan(t)) or j == pytest.approx(t, rel=1e-6), path
        return
    if isinstance(j, (str, int, bool, type(None))):
        assert j == t, (path, j, t)
        return
    if isinstance(j, enum.Enum):
        assert j.value == t.value, path
        return
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), (path, set(j) ^ set(t))
        for k in j:
            same(j[k], t[k], f"{path}[{k!r}]", seen, skip)
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            same(a, b, f"{path}[{i}]", seen, skip)
        return
    if isinstance(j, functools.partial):
        assert isinstance(t, functools.partial), path
        same(j.func, t.func, f"{path}.func", seen, skip)
        same(j.keywords, t.keywords, f"{path}.keywords", seen, skip)
        return
    seen.add(id(t))
    if callable(j) and not hasattr(j, "__dict__") or type(j).__name__ == "function":
        assert getattr(j, "__name__", None) == getattr(t, "__name__", None), path
        if j.__name__.startswith("override_"):  # sampler_config_override's closure
            same([c.cell_contents for c in j.__closure__],
                 [c.cell_contents for c in t.__closure__], f"{path}.<closure>", seen, skip)
        return
    assert type(j).__name__ == type(t).__name__, (path, type(j), type(t))
    if hasattr(j, "params") and callable(j.params):
        drop = skip.get(type(j).__name__, ())
        same({k: v for k, v in j.params().items() if k not in drop},
             {k: v for k, v in t.params().items() if k not in drop}, f"{path}.params()", seen,
             skip)
        return
    vj = {k: v for k, v in vars(j).items() if not k.startswith("_")}
    vt = {k: v for k, v in vars(t).items() if not k.startswith("_")}
    same(vj, vt, f"{path}.vars", seen, skip)
