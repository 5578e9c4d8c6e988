"""Build and bind the hand-written CUDA kernels in ``sonar_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). The build happens at first use, never at import, into
``<checkout>/build/kernels/<hash>/``, where ``<hash>`` covers the sources and
the flags: a changed source gets a new directory, so a stale library is never
loaded. Two processes building at once each write a private temporary file
and rename it into place.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused.cu",)
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_NAME = "libsonar_fused.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library if this hash has not been built; return its path.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    it in ``build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        (lib.parent / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.sonar_momentum_step.argtypes = [p, p, p, p, p, p, p, i64, i32, p]
    lib.sonar_momentum_step.restype = i32
    lib.sonar_scale_noise.argtypes = [p, p, p, i64, i32, f32, f32, i32, p]
    lib.sonar_scale_noise.restype = i32
    lib.sonar_error_string.argtypes = [i32]
    lib.sonar_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sonar_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}): {msg}")
