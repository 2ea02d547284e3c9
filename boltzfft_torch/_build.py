"""Build and load the port's CUDA kernels (nvcc into a plain C library).

At first use, ``load_library()`` compiles every ``csrc/*.cu`` to an object,
one ``nvcc`` per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v [FILE_FLAGS] -c -o build/boltzfft_torch/<name>.o <name>.cu

and links them with ``nvcc -shared`` into
``build/boltzfft_torch/libboltzfft_torch.so`` at the repository root.  It
rebuilds when the hash of the sources (``*.cu``, ``*.cuh``) and flags changes.
The library is bound with ``ctypes``: every pointer and the stream are
``c_void_p``, every int ``c_int``, every real scalar ``c_double``; each entry
returns ``cudaGetLastError()``.  A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import obs

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
#: Flags added for single sources.  The ds engine's kernels (K7-K12 and
#: the elementwise chains) need every + - * rounded on its own, so nvcc must
#: not contract a*b + c into one FMA there (``csrc/oz_common.cuh``,
#: ``csrc/ds_elementwise.cu``).  Never ``--use_fast_math`` or ``-ftz=true``:
#: they flush denormals.
FILE_FLAGS = {
    name: ["--fmad=false"]
    for name in ("oz_preslice.cu", "oz_contract.cu", "oz_gmain3.cu", "oz_gmain12.cu",
                 "oz_hadamard.cu", "oz_hadamard_half.cu", "ds_elementwise.cu")
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: argtypes of each entry point (the f32 and f64 ones alike).
_ENTRY_ARGS = {
    # 14 inputs, 5 buffers, 7 ints, 3 reals, the chunk marks (obs's ring, its
    # head, its size, the span's begin code) and the stream
    "bfft_fused_collide": [_P] * 14 + [_P] * 5 + [_I] * 7 + [_D] * 3 + [_P, _P, _I, _I] + [_P],
    # 10 inputs, 4 buffers, 6 ints, 3 reals and the stream
    "bfft_fused_gain_kron": [_P] * 10 + [_P] * 4 + [_I] * 6 + [_D] * 3 + [_P],
    # 13 inputs, 3 buffers, 7 ints, 3 reals and the stream
    "bfft_fused_gain": [_P] * 13 + [_P] * 3 + [_I] * 7 + [_D] * 3 + [_P],
    # 3 inputs, the output, 6 ints (dims and the launch plan) and the stream
    "bfft_alpha_multiply": [_P] * 3 + [_P] + [_I] * 6 + [_P],
    # 4 inputs, the output, the scratch, 4 ints, 3 reals and the stream
    "bfft_gain_reduce": [_P] * 4 + [_P] * 2 + [_I] * 4 + [_D] * 3 + [_P],
}
#: argtypes of the entry points without an f32/f64 pair (the ds engine's,
#: K1's plan, and obs's marks and node counts).
_ENTRY_ARGS_F32 = {
    # the ring, its head, its size, the span code and the stream: obs's mark
    "bfft_obs_mark": [_P, _P, _I, _I, _P],
    # a cudaGraph_t and the int64 output
    "bfft_graph_nodes": [_P, _P],
    # the capturing stream and the int64 output
    "bfft_capture_nodes": [_P, _P],
    # B, M, node_block and the 3-int output: K5's plan
    "bfft_gain_reduce_plan": [_I] * 3 + [_P],
    # Nx, Ny, Nz, is_f64 and the 3-int output: K1's shared-memory plan
    "bfft_k1_plan": [_I] * 4 + [_P],
    # Ny Nz and the 4-int output: K3's GEMM plan
    "bfft_kron_plan": [_I] + [_P],
    # 4 planes, the mask, 2 outputs, 16 ints (dims, strides, chunking, launch)
    # and the stream
    "bfft_oz_preslice": [_P] * 7 + [_I] * 16 + [_P],
    # 4 planes, 2 presliced, 2 matrices, 4 phase planes, 4 outputs, 12 ints
    # and the stream
    "bfft_oz_contract": [_P] * 16 + [_I] * 12 + [_P],
    # preslice, 6 matrices, scratch, 2 outputs, 9 ints and the stream
    "bfft_oz_gmain3": [_P] * 10 + [_I] * 9 + [_P],
    # preslice, 4 matrices, 4 outputs, 10 ints and the stream
    "bfft_oz_gmain12": [_P] * 9 + [_I] * 10 + [_P],
    # Nx, Ny, Nz/2, the node count, sx, the slices kept, the z block and the
    # 7-int output: K10's plan
    "bfft_oz_gmain12_plan": [_I] * 7 + [_P],
    # 8 stream planes, 2 weights, 4 outputs, the node count, 3 dims, 11
    # strides, the weights' stride and the stream
    "bfft_oz_hadamard": [_P] * 14 + [_I] * 16 + [_P],
    # the 37-pointer table, the node count, groups, 3 dims, the run, the
    # block size and the stream
    "bfft_oz_hadamard_half": [_P] + [_I] * 7 + [_P],
    # the chain's op code, double pairs or not, the table of addresses,
    # sizes and strides, the grid and the stream
    "bfft_ds_elementwise": [_I, _I, _P, _I, _P],
}

_lib = None


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu")) + sorted(_SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(FILE_FLAGS.items())).encode())
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


def _current(digest: str) -> bool:
    return LIB_PATH.exists() and _HASH_PATH.exists() and _HASH_PATH.read_text() == digest


def build() -> Path:
    """Compile the kernels if the library is missing or out of date."""
    digest = _digest()
    if _current(digest):
        return LIB_PATH
    obs.count("library", "builds")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    pid = os.getpid()
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{p.stem}.{pid}.o" for p in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(s.name, []), "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(compiles)) as pool:
        results = list(pool.map(_run, compiles))
    tmp = LIB_PATH.with_suffix(f".so.{pid}")
    if all(rc == 0 for rc, _out, _s in results):
        results.append(_run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
    wall = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    # Each step's seconds, and the build's wall time: the compiles run
    # together, so one nvcc over all sources would take about their sum.
    BUILD_LOG.write_text("\n".join(out for _rc, out, _s in results)
                         + "\n# build seconds: " + " ".join(f"{s:.2f}" for _rc, _o, s in results)
                         + f"; wall {wall:.2f}\n")
    failed = [out for rc, out, _s in results if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    sass = library_sass(nvcc, tmp)
    with BUILD_LOG.open("a") as log:
        log.write(f"# tensor-core instructions (HMMA, HGMMA, DMMA) per kernel: {count_tc(sass)}\n")
        log.write(f"# DMMA shapes per transform instance: {dmma_shapes(sass)}\n")
    os.replace(tmp, LIB_PATH)
    _HASH_PATH.write_text(digest)
    return LIB_PATH


#: Kernels whose tensor-core instructions ``count_tc`` reports: the ds
#: engine's tile kernels, and K1's (K2's, K4's, K3's x leg) axis transforms
#: and K3's y/z GEMM, whose float and double instances are told apart.
TC_KERNELS = ("oz_contract_kernel", "gmain3_kernel", "gmain12_kernel")
TC_TRANSFORMS = ("line_dft_kernel", "plane_dft_kernel", "kron_gemm_kernel")


def library_sass(nvcc: str, lib: Path) -> str:
    """The library's SASS (``cuobjdump -sass``, beside nvcc), for the checks
    that the exact chunk dots, K1's transforms and K3's GEMM run on the
    tensor cores.  Empty where cuobjdump is missing or fails."""
    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.exists():
        return ""
    proc = subprocess.run([str(tool), "-sass", str(lib)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.stdout if proc.returncode == 0 else ""


def count_tc(sass: str) -> dict:
    """{kernel: {instruction: count}} of the tensor-core instructions (HMMA,
    HGMMA, DMMA) in ``cuobjdump -sass`` text, summed over the instances of
    each kernel of ``TC_KERNELS`` and, per element type
    (``line_dft_kernel<double>``, ...), of ``TC_TRANSFORMS``."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            mangled = line.split("Function : ", 1)[1].strip()
            name = next((k for k in TC_KERNELS if k in mangled), None)
            for k in TC_TRANSFORMS:
                at = mangled.find(k)
                if at >= 0 and mangled[at + len(k):at + len(k) + 2] in ("Id", "If"):
                    elem = "double" if mangled[at + len(k) + 1] == "d" else "float"
                    name = f"{k}<{elem}>"
            if name is not None:
                counts.setdefault(name, {"HMMA": 0, "HGMMA": 0, "DMMA": 0})
        elif name is not None:
            m = re.search(r"\b(DMMA|HGMMA|HMMA)\b", line)
            if m:
                counts[name][m.group(1)] += 1
    return counts


_INSTANCE = re.compile(r"(%s)I([df])((?:L[bi]\d+E)*)E" % "|".join(TC_TRANSFORMS))


def dmma_shapes(sass: str) -> dict:
    """{instance: {shape: count}} of the DMMA instructions (``DMMA.8x8x4`` is
    m8n8k4, ``DMMA.16x8x16`` m16n8k16, ...) in ``cuobjdump -sass`` text, per
    instance of ``TC_TRANSFORMS`` with its template arguments, e.g.
    ``plane_dft_kernel<double,false,false>`` (kRealIn, kSplit)."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            m = _INSTANCE.search(line)
            name = None
            if m:
                args = ["double" if m.group(2) == "d" else "float"]
                for a in re.findall(r"L([bi])(\d+)E", m.group(3)):
                    args.append(("false", "true")[int(a[1])] if a[0] == "b" else a[1])
                name = f"{m.group(1)}<{','.join(args)}>"
                counts.setdefault(name, {})
        elif name is not None:
            m = re.search(r"\bDMMA\.(\w+)", line)
            if m:
                counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return counts


def _run(cmd: list[str]) -> tuple[int, str, float]:
    """(exit code, the command and its output, seconds) of one nvcc call."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = " ".join(cmd) + f"\n{proc.stdout}" + (f"(exit {proc.returncode})\n" if proc.returncode else "")
    return proc.returncode, out, time.perf_counter() - t0


def on_device(dev):
    """The context a launch on ``dev`` (a ``torch.device``) needs: none
    where ``dev`` is the current device already (the common case; entering
    ``torch.cuda.device`` costs host time on every call), else
    ``torch.cuda.device(dev)``."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """The SMs of CUDA device ``dev`` (a ``torch.device``): the launch plans'
    target (K5's route, K12's grid), read from the card, cached."""
    import torch

    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)


def load_library() -> ctypes.CDLL:
    """The built kernel library with its entry points' signatures set."""
    global _lib
    if _lib is None:
        with obs.span("library", built=not _current(_digest())):
            lib = ctypes.CDLL(str(build()))
        obs.count("library", "loads")
        for stem, argtypes in _ENTRY_ARGS.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, stem + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        for name, argtypes in _ENTRY_ARGS_F32.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
