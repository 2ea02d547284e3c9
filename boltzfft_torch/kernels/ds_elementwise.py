"""The ds engine's elementwise chains in one hand-written CUDA kernel each,
and their plain PyTorch versions.

No TPU kernel stands behind these: the JAX package pins the intermediates of
its error-free transforms (``boltzfft/ds.py::_opaque``) so that XLA fuses
each chain of ``boltzfft/ds.py`` into one loop under ``jit``; eager PyTorch
runs the same chain as 6-118 separate kernels.  ``csrc/ds_elementwise.cu``
is the card's counterpart of those loop fusions: each entry of :data:`OPS`
runs one chain of :mod:`boltzfft_torch.ds` per element in one launch,
rounding every ``+``, ``-`` and ``*`` on its own, so it gives the plain
chain's bits.

Each public function dispatches on the device of its operands: CUDA tensors
launch the kernel (a build or launch failure raises), CPU tensors run the
``*_reference`` plain chain (the chains of ``ds.py``, op for op).  The
:func:`plain_chains` context runs the plain chains on CUDA tensors too: it
is for tests and ``chip_smoke.py``, which hold whole evals against it.

Operands broadcast as PyTorch's do and are read in place through their
strides (:func:`plan`); the outputs are contiguous planes of the broadcast
shape, all of one call in one buffer.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ..ds import CDS, DS, neg, quick_two_sum, two_prod, two_sum

#: The kernel's chains: name -> (op code of ``csrc/ds_elementwise.cu``,
#: input planes, output planes).  A ds operand is two planes (hi, lo), a
#: complex one four (re hi, re lo, im hi, im lo), a sign pattern one.
OPS = {
    "add": (0, 4, 2),
    "sub": (1, 4, 2),
    "mul": (2, 4, 2),
    "mul_f": (3, 3, 2),
    "cadd": (4, 8, 4),
    "cmul": (5, 8, 4),
    "cmul_ds": (6, 6, 4),
    "cmul_both": (7, 8, 8),
    "axpy": (8, 6, 2),
    "caxpy": (9, 10, 4),
    "sub_mul": (10, 6, 2),
    "cadd_signed": (11, 9, 4),
    "add_signed": (12, 5, 2),
}
#: The entry's table: ``MAX_IN`` input and ``MAX_OUT`` output addresses,
#: ``MAX_DIMS`` sizes, ``MAX_IN x MAX_DIMS`` strides, the element count and
#: the dim count, all 64-bit (``EwArgs`` in the source).
MAX_IN, MAX_OUT, MAX_DIMS = 10, 8, 6
TABLE_WORDS = MAX_IN + MAX_OUT + MAX_DIMS + MAX_IN * MAX_DIMS + 2
#: Threads per block (``kThreads``), and blocks per SM at most: the
#: grid-stride loop walks the rest.
THREADS = 256
BLOCKS_PER_SM = 8

#: Launches of each CUDA kernel (one per call on CUDA tensors).
LAUNCHES = {name: 0 for name in OPS}
#: Calls of each plain version (CPU tensors, or CUDA under :func:`plain_chains`).
REFERENCE_CALLS = {name: 0 for name in OPS}

_plain = False


@contextlib.contextmanager
def plain_chains():
    """Run the plain chains on CUDA tensors as well (tests and
    ``chip_smoke.py``: a whole eval held bitwise against its kernels'
    run).  No function of the port's main path enters it."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


# ---------------------------------------------------------------------------
# the plain chains (those of ds.py, op for op)
# ---------------------------------------------------------------------------


def add_reference(x: DS, y: DS) -> DS:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    s, e = quick_two_sum(s, e)
    return DS(s, e)


def sub_reference(x: DS, y: DS) -> DS:
    return add_reference(x, neg(y))


def mul_reference(x: DS, y: DS) -> DS:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    p, e = quick_two_sum(p, e)
    return DS(p, e)


def mul_f_reference(x: DS, a) -> DS:
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    p, e = quick_two_sum(p, e)
    return DS(p, e)


def cadd_reference(x: CDS, y: CDS) -> CDS:
    return CDS(add_reference(x.re, y.re), add_reference(x.im, y.im))


def cmul_reference(x: CDS, y: CDS) -> CDS:
    return CDS(
        sub_reference(mul_reference(x.re, y.re), mul_reference(x.im, y.im)),
        add_reference(mul_reference(x.re, y.im), mul_reference(x.im, y.re)),
    )


def cmul_ds_reference(x: CDS, w: DS) -> CDS:
    return CDS(mul_reference(x.re, w), mul_reference(x.im, w))


def cmul_both_reference(a: CDS, f: CDS) -> tuple:
    rr = mul_reference(a.re, f.re)
    ii = mul_reference(a.im, f.im)
    ri = mul_reference(a.re, f.im)
    ir = mul_reference(a.im, f.re)
    t1 = CDS(sub_reference(rr, ii), add_reference(ri, ir))
    t2 = CDS(add_reference(rr, ii), sub_reference(ri, ir))
    return t1, t2


def axpy_reference(f: DS, k: DS, s: DS) -> DS:
    return add_reference(f, mul_reference(k, s))


def caxpy_reference(acc: CDS, x: CDS, w: DS) -> CDS:
    return cadd_reference(acc, cmul_ds_reference(x, w))


def sub_mul_reference(a: DS, b: DS, c: DS) -> DS:
    return sub_reference(a, mul_reference(b, c))


def cadd_signed_reference(p: CDS, t: CDS, pattern: torch.Tensor) -> CDS:
    signed = lambda d: DS(d.hi * pattern, d.lo * pattern)
    return cadd_reference(p, CDS(signed(t.re), signed(t.im)))


def add_signed_reference(p: DS, t: DS, pattern: torch.Tensor) -> DS:
    return add_reference(p, DS(t.hi * pattern, t.lo * pattern))


# ---------------------------------------------------------------------------
# the dispatching functions (ds.py's operators route here)
# ---------------------------------------------------------------------------


def _cds(t):
    return (t.re.hi, t.re.lo, t.im.hi, t.im.lo)


def add(x: DS, y: DS) -> DS:
    return _run("add", (x.hi, x.lo, y.hi, y.lo), add_reference, (x, y))


def sub(x: DS, y: DS) -> DS:
    return _run("sub", (x.hi, x.lo, y.hi, y.lo), sub_reference, (x, y))


def mul(x: DS, y: DS) -> DS:
    return _run("mul", (x.hi, x.lo, y.hi, y.lo), mul_reference, (x, y))


def mul_f(x: DS, a) -> DS:
    if not isinstance(a, torch.Tensor):  # a Python scalar: a float of the pairs' dtype
        a = torch.full((), a, dtype=x.hi.dtype, device=x.hi.device)
    return _run("mul_f", (x.hi, x.lo, a), mul_f_reference, (x, a))


def cadd(x: CDS, y: CDS) -> CDS:
    return _run("cadd", _cds(x) + _cds(y), cadd_reference, (x, y))


def cmul(x: CDS, y: CDS) -> CDS:
    return _run("cmul", _cds(x) + _cds(y), cmul_reference, (x, y))


def cmul_ds(x: CDS, w: DS) -> CDS:
    return _run("cmul_ds", _cds(x) + (w.hi, w.lo), cmul_ds_reference, (x, w))


def cmul_both(a: CDS, f: CDS) -> tuple:
    return _run("cmul_both", _cds(a) + _cds(f), cmul_both_reference, (a, f))


def axpy(f: DS, k: DS, s: DS) -> DS:
    return _run("axpy", (f.hi, f.lo, k.hi, k.lo, s.hi, s.lo), axpy_reference, (f, k, s))


def caxpy(acc: CDS, x: CDS, w: DS) -> CDS:
    return _run("caxpy", _cds(acc) + _cds(x) + (w.hi, w.lo), caxpy_reference, (acc, x, w))


def sub_mul(a: DS, b: DS, c: DS) -> DS:
    return _run("sub_mul", (a.hi, a.lo, b.hi, b.lo, c.hi, c.lo), sub_mul_reference, (a, b, c))


def cadd_signed(p: CDS, t: CDS, pattern: torch.Tensor) -> CDS:
    return _run("cadd_signed", _cds(p) + _cds(t) + (pattern,), cadd_signed_reference,
                (p, t, pattern))


def add_signed(p: DS, t: DS, pattern: torch.Tensor) -> DS:
    return _run("add_signed", (p.hi, p.lo, t.hi, t.lo, pattern), add_signed_reference,
                (p, t, pattern))


def _run(name, planes, reference, args):
    dev = planes[0].device
    if any(t.device != dev for t in planes):
        raise ValueError(f"ds.{name}: operands on more than one device")
    if dev.type == "cuda" and not _plain:
        return _pack(_ds_elementwise_cuda(name, planes))
    if dev.type == "cuda" or dev.type == "cpu":
        REFERENCE_CALLS[name] += 1
        return reference(*args)
    raise ValueError(f"ds.{name}: no kernel for device {dev}")


def _pack(out):
    """The output planes as the plain chain returns them."""
    if len(out) == 2:
        return DS(*out)
    if len(out) == 4:
        return CDS(DS(out[0], out[1]), DS(out[2], out[3]))
    return (CDS(DS(out[0], out[1]), DS(out[2], out[3])),
            CDS(DS(out[4], out[5]), DS(out[6], out[7])))


# ---------------------------------------------------------------------------
# the broadcast and stride plan, and the launch
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """``shape``: the broadcast output shape; ``sizes``: its dims once every
    dim of size 1 is dropped and every run of dims that all operands walk
    contiguously is merged (outermost first; ``(1,)`` for one element);
    ``strides``: each operand's element strides over ``sizes``, 0 where it
    broadcasts."""

    shape: tuple
    sizes: tuple
    strides: tuple


def broadcast_shape(shapes) -> tuple:
    """PyTorch's broadcast of ``shapes`` (a ValueError where they clash)."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for d, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[d] not in (1, n):
                    raise ValueError(f"ds elementwise: shapes {shapes} do not broadcast")
                out[d] = n
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def plan(shapes: tuple, strides: tuple) -> Plan:
    """The kernel's view of operands of ``shapes`` with element ``strides``
    (pure: no tensor, no device)."""
    shape = broadcast_shape(shapes)
    nd = len(shape)
    keep = [d for d in range(nd) if shape[d] != 1]
    walk = []  # per operand, its stride along each kept dim (0: broadcast)
    for s, st in zip(shapes, strides):
        pad = nd - len(s)
        walk.append([st[d - pad] if d >= pad and s[d - pad] != 1 else 0 for d in keep])
    sizes = [shape[d] for d in keep]
    m_sizes, m_walk = [], [[] for _ in walk]
    for j, n in enumerate(sizes):
        if m_sizes and all(mw[-1] == w[j] * n for mw, w in zip(m_walk, walk)):
            m_sizes[-1] *= n
            for mw, w in zip(m_walk, walk):
                mw[-1] = w[j]
        else:
            m_sizes.append(n)
            for mw, w in zip(m_walk, walk):
                mw.append(w[j])
    if not m_sizes:
        m_sizes, m_walk = [1], [[0] for _ in walk]
    if len(m_sizes) > MAX_DIMS:
        raise ValueError(f"ds elementwise: {len(m_sizes)} dims after merging, the kernel"
                         f" takes {MAX_DIMS}")
    return Plan(shape, tuple(m_sizes), tuple(tuple(w) for w in m_walk))


def _tail(pl: Plan) -> list:
    """The words after the addresses: sizes, strides, count, dims."""
    nd = len(pl.sizes)
    words = list(pl.sizes) + [1] * (MAX_DIMS - nd)
    for k in range(MAX_IN):
        st = pl.strides[k] if k < len(pl.strides) else ()
        words += list(st) + [0] * (MAX_DIMS - len(st))
    n = 1
    for v in pl.sizes:
        n *= v
    return words + [n, nd]


class _Launch(NamedTuple):
    """What a call needs beyond its operands' addresses, per chain and
    operand layout."""

    shape: tuple  # the output planes' shape
    n_out: int
    n: int  # elements a plane
    tail: list  # the table after the addresses
    blocks: int
    code: int
    f64: int


_launches: dict = {}  # (chain, dtype, device, shapes, strides, dtypes) -> _Launch
_Table = ctypes.c_int64 * TABLE_WORDS


def _launch_for(name, planes) -> _Launch:
    from .._build import sm_count

    code, _n_in, n_out = OPS[name]
    dtype = planes[-2].dtype if name.endswith("_signed") else planes[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ds.{name}: the kernel takes float32 or float64 pairs, not {dtype}")
    pattern = planes[-1].dtype if name.endswith("_signed") else dtype
    if pattern != dtype and not (pattern == torch.float32 and dtype == torch.float64):
        raise ValueError(f"ds.{name}: a {pattern} pattern on {dtype} pairs")
    if any(t.dtype != dtype for t in (planes[:-1] if name.endswith("_signed") else planes)):
        raise ValueError(f"ds.{name}: operands of more than one dtype")
    pl = plan(tuple(tuple(t.shape) for t in planes), tuple(tuple(t.stride()) for t in planes))
    n = 1
    for v in pl.shape:
        n *= v
    blocks = min(-(-n // THREADS), BLOCKS_PER_SM * sm_count(planes[0].device))
    return _Launch(pl.shape, n_out, n, _tail(pl), blocks, code, int(dtype == torch.float64))


def _ds_elementwise_cuda(name, planes) -> tuple:
    """One launch of the chain ``name`` on CUDA planes; the output planes."""
    from .._build import load_library, on_device

    dev = planes[0].device
    key = (name, dev) + tuple((t.shape, t.stride(), t.dtype) for t in planes)
    ln = _launches.get(key)
    if ln is None:
        ln = _launches[key] = _launch_for(name, planes)
    if torch.is_grad_enabled() and any(t.requires_grad for t in planes):
        raise RuntimeError(f"ds.{name}: the CUDA kernel has no backward")
    dtype = torch.float64 if ln.f64 else torch.float32
    if planes[-1].dtype != dtype:  # a float32 sign pattern on float64 pairs: exact
        planes = planes[:-1] + (planes[-1].to(dtype),)
    out = torch.empty((ln.n_out,) + ln.shape, dtype=dtype, device=dev)
    if ln.n == 0:
        return out.unbind(0)
    o, step = out.data_ptr(), ln.n * out.element_size()
    ptrs = [t.data_ptr() for t in planes]
    args = _Table(*ptrs, *[0] * (MAX_IN - len(ptrs)),
                  *[o + k * step for k in range(ln.n_out)], *[0] * (MAX_OUT - ln.n_out), *ln.tail)
    lib = load_library()
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_ds_elementwise(ln.code, ln.f64, args, ln.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"ds.{name}: CUDA kernel failed with cudaError {rc}")
    LAUNCHES[name] += 1
    return out.unbind(0)
