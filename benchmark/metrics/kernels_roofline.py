"""kernels_roofline: the port's own kernels (every file of
``benchmark/kernels/``) in the traced calls: the sum of each launch's least
time (its file's ``least_seconds``, worked out from the traffic) over the
sum of their device times. Nothing to read where none of them ran."""

import importlib
import pkgutil

from .. import kernels

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def bounds():
    for m in pkgutil.iter_modules(kernels.__path__):
        if not m.name.startswith("_"):
            yield importlib.import_module(f"{kernels.__name__}.{m.name}")


def read(run):
    t = run["trace"]
    if not t:
        return None
    traffic = run["traffic"]
    itemsize = ITEMSIZE[run["config"]["dtype"]]
    least = actual = 0.0
    for mod in bounds():
        one = mod.least_seconds(traffic, itemsize)
        for k in t["ops"]:
            if k["kind"] == "kernel" and any(n in k["name"] for n in mod.NAMES):
                least += one
                actual += (k["end"] - k["start"]) / 1e9
    return least / actual * 100.0 if actual else None
