"""Build and load the Hopper kernels (every ``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all
of them at once (one ``nvcc`` process per source), and the objects are
linked into one plain-C shared library loaded with ``ctypes`` — no
PyTorch headers, so the build takes seconds.  The library lands in
``repro_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of all the sources, so an edited source rebuilds and concurrent
processes never load a half-written file (each builds under temporary
names and renames the library into place).

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
from typing import List, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: Optional[ctypes.CDLL] = None
#: seconds this process spent compiling (0.0 when it reused a build)
build_seconds: float = 0.0
#: ptxas's report (registers, shared memory, spills per kernel) of this
#: process's build ("" when it reused a build)
build_log: str = ""


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
        "the sources in csrc/"
    )


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libgym_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands at once; raise with the output of any that fail,
    else return what they wrote to stderr."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    errors, logs = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return "".join(logs)


def compile_library() -> Path:
    """Compile the sources (if no library for these exact sources exists)."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="build."))
    try:
        objs = [tmpdir / (src.stem + ".o") for src in sources()]
        t0 = time.perf_counter()
        build_log = _run_all([
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC",
             "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)
        ])
        lib = tmpdir / out.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        build_seconds = time.perf_counter() - t0
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(compile_library()))
    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.gym_hash_partition.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, vp]
    lib.gym_semijoin_probe.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, vp]
    # q, keys, bits, out, segments, n, m, bound, words, stream
    lib.gym_semijoin_bitmap.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, ll, vp]
    # q, keys, lo, hi, meff, spl, segments, n, m, ns_cap, stream
    lib.gym_sorted_probe.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, ci, vp]
    # q, k, v, o, dtype, B, H, KVH, Sq, Skv, D, scale, causal, window, softcap, stream
    lib.gym_flash_attention.argtypes = [
        vp, vp, vp, vp, ci, ll, ll, ll, ll, ll, ci, cf, ci, ci, cf, vp,
    ]
    # buf, valid, col_bits, out, segments, c, arity, row_bits, stream
    lib.gym_wire_encode.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, vp]
    # packed, col_bits, buf, valid, segments, c, arity, row_bits, stream
    lib.gym_wire_decode.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, vp]
    for fn in (lib.gym_hash_partition, lib.gym_semijoin_probe, lib.gym_semijoin_bitmap,
               lib.gym_sorted_probe, lib.gym_flash_attention, lib.gym_wire_encode,
               lib.gym_wire_decode):
        fn.restype = ci
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA tensor's
    device: a far cheaper host call than building the ``Stream`` object
    that ``torch.cuda.current_stream`` returns (``PERF.md``)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
