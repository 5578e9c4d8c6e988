"""Build and bind the hand-written CUDA kernels in ``sonar_tpu_torch/csrc``.

Each ``.cu`` source is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C interface,
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
The build happens at first use, never at import, into
``<checkout>/build/kernels/<hash>/``, where ``<hash>`` covers every source
(headers included) and each source's flags: a changed source gets a new
directory, so a stale library is never loaded. B1–B6 compile with
``-fmad=false``, which their bitwise agreement with their plain versions
needs; ``attention.cu`` with FMA contraction on, its inner products being
FFMAs. Two processes building at once each work
in a private temporary directory and rename the library into place.
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
SOURCES = ("elem.cuh", "philox.cuh", "fused.cu", "hwrng.cu", "fused_pyramid.cu", "voronoi.cu",
           "attention.cu")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
FMAD = {"attention.cu": "-fmad=true"}  # every other source: -fmad=false
LINK_FLAGS = (*ARCH, "-shared")
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


def nvcc_flags(src: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, FMAD.get(src, "-fmad=false"))


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        if name.endswith(".cu"):
            h.update(" ".join(nvcc_flags(name)).encode())
    h.update(" ".join(LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library if this hash has not been built; return its path.
    The compilers' output (``-Xptxas -v``: registers, spills) is kept beside
    it in ``build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=lib.parent))
    nvcc = _nvcc()
    try:
        jobs = []
        for src in (s for s in SOURCES if s.endswith(".cu")):
            obj = work / (src + ".o")
            cmd = [nvcc, *nvcc_flags(src), "-c", "-o", str(obj), str(CSRC / src)]
            log = open(work / (src + ".log"), "w")
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        text, failed = [], []
        for cmd, obj, log, proc in jobs:
            proc.wait()
            log.close()
            text.append(" ".join(cmd) + "\n" + pathlib.Path(log.name).read_text())
            if proc.returncode != 0:
                failed.append(obj.name)
        if not failed:
            tmp = work / LIB_NAME
            cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(j[1]) for j in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            text.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(LIB_NAME)
        (lib.parent / "build.log").write_text("".join(text))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(text))
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.sonar_momentum_step.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, p]
    lib.sonar_momentum_step.restype = i32
    lib.sonar_scale_noise.argtypes = [p, p, p, i64, i32, f32, f32, i32, i32, p]
    lib.sonar_scale_noise.restype = i32
    lib.sonar_scale_noise_split.argtypes = [i32, p, p, i64, p, p, f32, f32, i32, i32, p]
    lib.sonar_scale_noise_split.restype = i32
    u32 = ctypes.c_uint32
    lib.sonar_philox_fill.argtypes = [p, i64, u32, u32, u32, i32, i32, p]
    lib.sonar_philox_fill.restype = i32
    lib.sonar_philox_fill_shard.argtypes = [p, i64, u32, u32, u32, i32, i32, i64, i64, i64, p]
    lib.sonar_philox_fill_shard.restype = i32
    lib.sonar_box_muller_probe.argtypes = [p, p, p, u32, i64, p]
    lib.sonar_box_muller_probe.restype = i32
    lib.sonar_pyramid_up.argtypes = [p, p, i32, i32, i32, i32, i32, p, p, p, i32, u32,
                                     u32, f32, i64, i64, i64, p]
    lib.sonar_pyramid_up.restype = i32
    lib.sonar_pyramid_down.argtypes = [p, p, i32, i32, i32, i32, p, p, p, i32, u32,
                                       u32, i32, i64, i64, i64, p]
    lib.sonar_pyramid_down.restype = i32
    lib.sonar_voronoi_ksmallest.argtypes = [p, i64, p, i64, p, p, p, i32, i32, i32, i32,
                                            i32, i32, f32, f32, f32, f32, f32, f32, p]
    lib.sonar_voronoi_ksmallest.restype = i32
    lib.sonar_attention.argtypes = [p, i64, i64, i64, i64, i32, i32, i32, i32, i32, p, i64,
                                     i64, i64, f32, i32, p]
    lib.sonar_attention.restype = i32
    lib.sonar_error_string.argtypes = [i32]
    lib.sonar_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sonar_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}): {msg}")
