"""sonar_tpu_torch — the PyTorch and CUDA port of sonar_tpu, for one NVIDIA
H100.

Same subpackages and module names as ``sonar_tpu``, PyTorch idiom inside:
plain functions on tensors, ``nn.Module`` for the UNet, an explicit device,
explicit ``torch.Generator``s. The hot elementwise passes are hand-written
CUDA kernels (``kernels``), compiled at first use.

Importing the package imports no subpackage: each loads on first attribute
access, so ``import sonar_tpu_torch`` pulls in neither JAX (never used
here), nor Triton, nor the kernel library.
"""

import importlib

__version__ = "0.1.0"

_SUBPACKAGES = ("core", "kernels", "models", "noise", "samplers")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted((*globals(), *_SUBPACKAGES))
