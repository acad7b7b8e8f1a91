"""Build and load the Hopper kernels (``csrc/gym_kernels.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a plain-C shared
library at first use and loaded with ``ctypes`` — no PyTorch headers, so
the build takes seconds.  The library lands in ``repro_torch/_build/``
(listed in ``.gitignore``) under a name keyed by the source's hash, so an
edited source rebuilds and concurrent processes never load a half-written
file (each compiles to a temporary name and renames it into place).

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "gym_kernels.cu"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: Optional[ctypes.CDLL] = None
#: seconds this process spent compiling (0.0 when it reused a build)
build_seconds: float = 0.0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
        "'cuda' local backend needs the CUDA toolkit to build "
        f"{SOURCE.name}"
    )


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgym_kernels_{digest}.so"


def compile_library() -> Path:
    """Compile the source (if no library for this exact source exists)."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", tmp, str(SOURCE),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(compile_library()))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gym_hash_partition.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, vp]
    lib.gym_semijoin_probe.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, vp]
    lib.gym_sorted_probe.argtypes = [vp, vp, vp, vp, ll, ll, ll, vp]
    for fn in (lib.gym_hash_partition, lib.gym_semijoin_probe, lib.gym_sorted_probe):
        fn.restype = ci
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
