"""Build and load the port's CUDA kernels (nvcc into a plain C library).

At first use, ``load_library()`` compiles every ``csrc/*.cu`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/boltzfft_torch/libboltzfft_torch.so

into ``build/boltzfft_torch/`` at the repository root, and rebuilds when the
hash of the sources (and flags) changes.  The library is bound with ``ctypes``:
every pointer and the stream are ``c_void_p``, every int ``c_int``, every real
scalar ``c_double``; each entry returns ``cudaGetLastError()``.  A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
_SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "boltzfft_torch"
LIB_PATH = BUILD_DIR / "libboltzfft_torch.so"
#: nvcc's output of the last build (``-Xptxas -v``: registers, shared memory,
#: spills per kernel).
BUILD_LOG = BUILD_DIR / "build.log"
_HASH_PATH = BUILD_DIR / "sources.sha256"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: argtypes of bfft_fused_collide_{f32,f64}: 14 inputs, 5 buffers, 7 ints,
#: 3 reals and the stream.
_FUSED_COLLIDE_ARGS = [_P] * 14 + [_P] * 5 + [_I] * 7 + [_D] * 3 + [_P]

_lib = None


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu")) + sorted(_SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the boltzfft_torch CUDA "
        "kernels cannot be built"
    )


def build() -> Path:
    """Compile the kernels if the library is missing or out of date."""
    digest = _digest()
    if LIB_PATH.exists() and _HASH_PATH.exists() and _HASH_PATH.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".so.{os.getpid()}")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    _HASH_PATH.write_text(digest)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """The built kernel library with its entry points' signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("bfft_fused_collide_f32", "bfft_fused_collide_f64"):
            fn = getattr(lib, name)
            fn.argtypes = _FUSED_COLLIDE_ARGS
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
