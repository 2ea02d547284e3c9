"""Double-single ("ds") arithmetic on tensors (mirror of ``boltzfft/ds.py``).

Every value is an unevaluated sum ``hi + lo`` of two hardware floats with
``|lo| <= ulp(hi)/2``: float32 pairs carry ~48-49 mantissa bits (~1e-14
relative).  The primitives are the classical error-free transformations
(Dekker 1971, Knuth TAOCP 4.2.2), written as elementwise tensor ops.

They are right only if every ``+``, ``-`` and ``*`` is rounded on its own.
The JAX package pins each intermediate with ``lax.reduce_precision``
(its ``_opaque``) because XLA fuses, duplicates and FMA-contracts.  The
port keeps the rule in two halves.

- CPU tensors run the chains below op by op: eager PyTorch runs each
  operator as one kernel with one correctly rounded result, so nothing
  needs a pin.  These functions must never run under ``torch.compile`` (its
  code generator may contract ``a*b + c`` into one FMA), and no fused
  multiply-add operator (``addcmul``, ``addcdiv``, ``torch.add(...,
  alpha=)`` with a product) may replace a product and a sum.
- On CUDA tensors the ds operators (``add``, ``sub``, ``mul``, ``mul_f``,
  ``cadd``, ``cmul``, ``cmul_ds``, ``cmul_both``) and the compositions the
  engine makes of them (``axpy``, ``caxpy``, ``sub_mul``, ``cadd_signed``,
  ``add_signed``) each run as one launch of ``csrc/ds_elementwise.cu``
  (:mod:`boltzfft_torch.kernels.ds_elementwise`), the card's counterpart of
  the loop XLA fuses each chain into: every operation through a
  round-to-nearest intrinsic (``__fadd_rn``, ...), built with
  ``--fmad=false``, so the bits are the chain's.  ``two_sum``,
  ``quick_two_sum``, ``split`` and ``two_prod`` stay plain on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DS(NamedTuple):
    """A double-single tensor: value = hi + lo (elementwise, non-overlapping)."""

    hi: torch.Tensor
    lo: torch.Tensor


class CDS(NamedTuple):
    """A complex double-single tensor."""

    re: DS
    im: DS


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over matching (named) tuples of tensors, as
    ``jax.tree.map`` does over the JAX package's DS/CDS pytrees; ``None``
    stays ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        parts = [tree_map(fn, *cols) for cols in zip(*trees)]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)
    return fn(*trees)


# ---------------------------------------------------------------------------
# error-free transformations (elementwise, broadcasting)
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth/Moller, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """two_sum assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split_factor(dtype) -> float:
    # 2^ceil(p/2) + 1 for a p-bit mantissa (Dekker splitting constant)
    p = {torch.float32: 24, torch.float64: 53}[dtype]
    return float(2 ** ((p + 1) // 2) + 1)


def split(a):
    """a == h + l with h, l each holding ~half the mantissa bits."""
    c = a * _split_factor(a.dtype)
    h = c - (c - a)
    return h, a - h


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker, ~17 flops)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# ds arithmetic
# ---------------------------------------------------------------------------


def from_float(a: torch.Tensor) -> DS:
    """Promote a hardware float tensor (exact: lo = 0)."""
    return DS(a, torch.zeros_like(a))


def from_f64(a, dtype=torch.float32, device="cuda") -> DS:
    """Split a host float64 array into a ds pair of ``dtype`` on ``device``
    (hi = round(a), lo = round(a - hi)); relative representation error
    ~2^-2p.  Like every constructor here it builds on the card unless
    asked for the CPU."""
    a = np.asarray(a, np.float64)
    npd = np.float32 if dtype == torch.float32 else np.float64
    hi = a.astype(npd)
    lo = (a - hi.astype(np.float64)).astype(npd)
    return DS(torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device))


def to_f64(x: DS) -> np.ndarray:
    """Exact host reconstruction (float64 holds a float32 pair exactly)."""
    hi = x.hi.detach().cpu().numpy().astype(np.float64)
    lo = x.lo.detach().cpu().numpy().astype(np.float64)
    return hi + lo


def zeros(shape, dtype=torch.float32, device="cuda") -> DS:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return DS(z, z)


def neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def add(x: DS, y: DS) -> DS:
    """IEEE-style ds add (11 flops, error O(2^-2p))."""
    return _ew.add(x, y)


def sub(x: DS, y: DS) -> DS:
    """``add(x, neg(y))``."""
    return _ew.sub(x, y)


def mul(x: DS, y: DS) -> DS:
    """ds multiply (~25 flops; drops only the lo*lo term, O(2^-2p))."""
    return _ew.mul(x, y)


def mul_f(x: DS, a) -> DS:
    """ds times a plain hardware float (exact split of the single product):
    a tensor, or a Python scalar taken as a float of the pairs' dtype (rounded
    to it)."""
    return _ew.mul_f(x, a)


# ---------------------------------------------------------------------------
# complex ds
# ---------------------------------------------------------------------------


def cds_from_f64(a, dtype=torch.float32, device="cuda") -> CDS:
    a = np.asarray(a)
    return CDS(from_f64(a.real, dtype, device), from_f64(a.imag, dtype, device))


def cds_from_real(x: DS) -> CDS:
    z = torch.zeros_like(x.hi)  # one zero plane for both words, as zeros() makes
    return CDS(x, DS(z, z))


def cds_to_c128(x: CDS) -> np.ndarray:
    return to_f64(x.re) + 1j * to_f64(x.im)


def czeros(shape, dtype=torch.float32, device="cuda") -> CDS:
    return CDS(zeros(shape, dtype, device), zeros(shape, dtype, device))


def cadd(x: CDS, y: CDS) -> CDS:
    """Complex ds add."""
    return _ew.cadd(x, y)


def cmul(x: CDS, y: CDS) -> CDS:
    """Complex ds multiply: ``(sub(xr yr, xi yi), add(xr yi, xi yr))``."""
    return _ew.cmul(x, y)


def cconj(x: CDS) -> CDS:
    return CDS(x.re, neg(x.im))


def cmul_both(a: CDS, f: CDS) -> tuple:
    """``(a * f, conj(a) * f)`` sharing the four component products."""
    return _ew.cmul_both(a, f)


def cmul_ds(x: CDS, w: DS) -> CDS:
    """Complex ds times real ds."""
    return _ew.cmul_ds(x, w)


# ---------------------------------------------------------------------------
# the compositions the engine makes (one launch each on the card; the JAX
# package writes them out and XLA fuses each into one loop)
# ---------------------------------------------------------------------------


def axpy(f: DS, k: DS, s: DS) -> DS:
    """``add(f, mul(k, s))``: the RK stage input and update."""
    return _ew.axpy(f, k, s)


def caxpy(acc: CDS, x: CDS, w: DS) -> CDS:
    """``cadd(acc, cmul_ds(x, w))``: the gain accumulation."""
    return _ew.caxpy(acc, x, w)


def sub_mul(a: DS, b: DS, c: DS) -> DS:
    """``sub(a, mul(b, c))``: the gain minus loss assembly."""
    return _ew.sub_mul(a, b, c)


def cadd_signed(p: CDS, t: CDS, pattern: torch.Tensor) -> CDS:
    """``cadd(p, t * pattern)``, every plane of ``t`` multiplied by the
    (broadcast) ``pattern``: the Nyquist corrections' exact +-1 folds."""
    return _ew.cadd_signed(p, t, pattern)


def add_signed(p: DS, t: DS, pattern: torch.Tensor) -> DS:
    """``add(p, t * pattern)``, the real form of :func:`cadd_signed`."""
    return _ew.add_signed(p, t, pattern)


# ---------------------------------------------------------------------------
# linear algebra: last-axis contraction and 3-D tensor transforms (the "vpu"
# engine: compensated rank-1 updates, no kernel)
# ---------------------------------------------------------------------------


def _index_last(x: DS, k: int) -> DS:
    return DS(x.hi[..., k : k + 1], x.lo[..., k : k + 1])


def _row(m: DS, k: int) -> DS:
    return DS(m.hi[k], m.lo[k])


def contract_last(x: CDS, m: CDS, real_in: bool = False, real_out: bool = False) -> CDS:
    """``out[..., l] = sum_k x[..., k] * m[k, l]`` in full ds arithmetic, as
    ``K`` compensated rank-1 updates in order (the bit reference of the oz
    engines; the JAX package's ``block`` unrolling changes no bit and has no
    counterpart).  ``real_in`` treats the imaginary input as exactly zero;
    ``real_out`` returns zeros for the imaginary output without computing
    it."""
    n = m.re.hi.shape[0]
    out_shape = tuple(x.re.hi.shape[:-1]) + (m.re.hi.shape[1],)
    acc = czeros(out_shape, x.re.hi.dtype, x.re.hi.device)
    for k in range(n):
        xr = _index_last(x.re, k)  # (..., 1)
        mr, mi = _row(m.re, k), _row(m.im, k)  # (M,)
        if real_in:
            re = mul(xr, mr)
            im = None if real_out else mul(xr, mi)
        else:
            xi = _index_last(x.im, k)
            re = sub(mul(xr, mr), mul(xi, mi))
            im = None if real_out else add(mul(xr, mi), mul(xi, mr))
        acc = CDS(add(acc.re, re), acc.im if im is None else add(acc.im, im))
    return acc


def _swap_last2(x: CDS) -> CDS:
    return tree_map(lambda a: a.transpose(-1, -2), x)


def _roll_axis(x: CDS, src: int, dst: int) -> CDS:
    return tree_map(lambda a: torch.movedim(a, src, dst), x)


def _per_axis(m):
    """An (mx, my, mz) triple from one shared CDS matrix or a per-axis tuple
    (CDS is itself a NamedTuple, so test the type)."""
    return (m, m, m) if isinstance(m, CDS) else tuple(m)


def transform3(x: CDS, m, real_in: bool = False, real_out: bool = False) -> CDS:
    """Separable 3-D transform of the trailing (Nx, Ny, Nz) axes with the
    (N_axis, N_axis) ds matrices ``m`` (shared, or a per-axis tuple)."""
    mx, my, mz = _per_axis(m)
    x = contract_last(x, mz, real_in=real_in)  # z
    x = _swap_last2(contract_last(_swap_last2(x), my))  # y
    return _roll_axis(  # x
        contract_last(_roll_axis(x, -3, -1), mx, real_out=real_out), -1, -3
    )


# the kernels' wrappers import this module's types and transforms, so they
# come last
from .kernels import ds_elementwise as _ew  # noqa: E402
