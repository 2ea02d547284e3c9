"""The ds engine's fused elementwise chains (``kernels/ds_elementwise.py``,
``csrc/ds_elementwise.cu``) on the CPU.

- The compositions the engine's call sites make (``axpy``, ``caxpy``,
  ``sub_mul``, ``cadd_signed``, ``add_signed``) run their plain chains on
  CPU tensors, bitwise equal to the same composition of ``boltzfft.ds``
  functions in JAX, op by op on the CPU, on seeded inputs.
- The broadcast and stride plan, and the whole CUDA wrapper held against an
  entry that walks the kernel's index arithmetic in NumPy over the raw
  memory and applies the plain chain per element: bitwise equal to the
  plain chain on the broadcast operands, for contiguous, stride-0,
  permuted, sliced and scalar operands.
- The build keeps ``--fmad=false`` and no fast-math flag for the source;
  the op codes and the table's layout match the source; a CPU tensor counts
  no launch; the ds eval and the ds RK4 step on the CPU reach the
  compositions.
"""

import contextlib
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft import ds as jds
from boltzfft_torch import _build, ds
from boltzfft_torch import ds_operator as dso
from boltzfft_torch.kernels import ds_elementwise as ew

SRC = _build._SRC_DIR / "ds_elementwise.cu"
NP = {torch.float32: np.float32, torch.float64: np.float64}


def _values(rng, shape):
    """Host float64 values over 2^-20..2^20, both signs."""
    mag = 2.0 ** rng.uniform(-20, 20, shape)
    return rng.choice([-1.0, 1.0], shape) * mag * (1 + rng.uniform(0, 1, shape))


def _signs(rng, shape):
    return rng.choice([-1.0, 1.0], shape).astype(np.float32)


# name -> the operands' kinds and shapes ("d" ds, "c" complex ds, "p" a float32
# sign pattern), as the call sites give them
COMPOSITES = {
    "axpy": (("d", (6, 7)), ("d", (6, 7)), ("d", ())),  # RK: f + a k, a scalar
    "caxpy": (("c", (3, 4, 5)), ("c", (3, 4, 5)), ("d", (4, 5))),  # acc + x w
    "sub_mul": (("d", (4, 5, 6)), ("d", (4, 5, 6)), ("d", (4, 5, 6))),  # gain - loss f
    "cadd_signed": (("c", (2, 3, 4, 5)), ("c", (2, 3, 4, 1)), ("p", (1, 1, 1, 5))),
    "add_signed": (("d", (2, 4, 5, 6)), ("d", (2, 4, 5, 1)), ("p", (6,))),
}


def _jax_composite(name, a, b, c):
    """The composition in the JAX package's ds functions."""
    if name == "axpy":
        return jds.add(a, jds.mul(b, c))
    if name == "caxpy":
        return jds.cadd(a, jds.cmul_ds(b, c))
    if name == "sub_mul":
        return jds.sub(a, jds.mul(b, c))
    signed = lambda d: jds.DS(d.hi * c, d.lo * c)
    if name == "cadd_signed":
        return jds.cadd(a, jds.CDS(signed(b.re), signed(b.im)))
    return jds.add(a, signed(b))


def _leaves(tree):
    out = []
    ds.tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composites_bitwise_against_jax(name, dtype):
    rng = np.random.default_rng(sorted(COMPOSITES).index(name))
    npd = NP[dtype]
    args_t, args_j = [], []
    for kind, shape in COMPOSITES[name]:
        if kind == "p":
            p = _signs(rng, shape)
            args_t.append(torch.as_tensor(p))
            args_j.append(jnp.asarray(p))
        elif kind == "d":
            v = _values(rng, shape)
            args_t.append(ds.from_f64(v, dtype, "cpu"))
            args_j.append(jds.from_f64(v, npd))
        else:
            v = _values(rng, shape) + 1j * _values(rng, shape)
            args_t.append(ds.cds_from_f64(v, dtype, "cpu"))
            args_j.append(jds.cds_from_f64(v, npd))
    calls = ew.REFERENCE_CALLS[name]
    got = getattr(ds, name)(*args_t)
    assert ew.REFERENCE_CALLS[name] == calls + 1
    want = _jax_composite(name, *args_j)
    for g, w in zip(_leaves(got), jds_leaves(want)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def jds_leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in jds_leaves(t)]
    return [tree]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mul_f_takes_a_python_scalar(dtype):
    """``ds.mul_f(x, 1e-3)`` as ``boltzfft.ds.mul_f`` takes it: the scalar
    is a float of the pairs' dtype (JAX's float32 pairs are given it as one:
    a Python float there is split in float64)."""
    rng = np.random.default_rng(7)
    v = _values(rng, (5, 7))
    npd = NP[dtype]
    got = ds.mul_f(ds.from_f64(v, dtype, "cpu"), 1e-3)
    want = jds.mul_f(jds.from_f64(v, npd), 1e-3 if dtype == torch.float64 else npd(1e-3))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_tensor_counts_no_launch():
    x = ds.from_f64(np.arange(1.0, 9.0), torch.float32, "cpu")
    launches, calls = dict(ew.LAUNCHES), dict(ew.REFERENCE_CALLS)
    out = ds.add(x, x)
    assert ew.LAUNCHES == launches
    assert ew.REFERENCE_CALLS["add"] == calls["add"] + 1
    np.testing.assert_array_equal(ds.to_f64(out), 2.0 * np.arange(1.0, 9.0))
    with ew.plain_chains():  # the context changes nothing on the CPU
        assert torch.equal(ds.add(x, x).hi, out.hi)
        with ew.plain_chains():
            pass
        assert ew._plain
    assert not ew._plain


def test_operands_on_two_devices_raise():
    x = ds.from_f64(np.ones(4), torch.float32, "cpu")
    y = ds.DS(torch.empty(4, device="meta"), torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="more than one device"):
        ds.mul(x, y)


def test_build_flags_keep_every_rounding():
    flags = _build.FILE_FLAGS["ds_elementwise.cu"]
    assert "--fmad=false" in flags
    assert not any(f in flags for f in ("--use_fast_math", "-use_fast_math", "-ftz=true",
                                        "--ftz=true", "-prec-div=false", "-prec-sqrt=false"))
    assert not any("fast_math" in f or "ftz=true" in f for f in _build.NVCC_FLAGS)
    # every operation of the chains through a round-to-nearest intrinsic
    body = SRC.read_text().split("// ---- the error-free transforms", 1)[1]
    body = body.split("// ---- the kernel", 1)[0]
    assert "fma" not in body.lower()


def test_op_codes_and_table_match_the_source():
    text = SRC.read_text()
    enum = re.search(r"enum OpCode \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "kNumOps"
    camel = lambda s: "k" + "".join(p.capitalize() for p in s.split("_"))
    for name, (code, n_in, n_out) in ew.OPS.items():
        assert names[code] == camel(name)
        m = re.search(rf"struct {camel(name)[1:]} \{{[^\n]*\n\s*"
                      r"static constexpr int kIn = (\d+), kOut = (\d+);", text)
        assert m and (int(m.group(1)), int(m.group(2))) == (n_in, n_out), name
    for const, value in (("kMaxIn", ew.MAX_IN), ("kMaxOut", ew.MAX_OUT),
                         ("kMaxDims", ew.MAX_DIMS), ("kThreads", ew.THREADS)):
        assert re.search(rf"constexpr int {const} = {value};", text), const


@pytest.mark.parametrize("shapes, strides, sizes, walk", [
    (((4, 5, 6), (4, 5, 6)), ((30, 6, 1), (30, 6, 1)), (120,), ((1,), (1,))),
    (((4, 5, 6), ()), ((30, 6, 1), ()), (120,), ((1,), (0,))),  # a scalar
    (((4, 5, 6), (6,)), ((30, 6, 1), (1,)), (20, 6), ((6, 1), (0, 1))),  # a row
    (((4, 5, 6), (4, 1, 1)), ((30, 6, 1), (1, 1, 1)), (4, 30), ((30, 1), (1, 0))),
    (((4, 5, 6), (4, 5, 6)), ((30, 6, 1), (1, 4, 20)), (4, 5, 6), ((30, 6, 1), (1, 4, 20))),
    (((1, 5, 1), (3, 1, 7)), ((5, 1, 1), (7, 7, 1)), (3, 5, 7), ((0, 1, 0), (7, 0, 1))),
    (((), ()), ((), ()), (1,), ((0,), (0,))),
])
def test_plan_merges_and_broadcasts(shapes, strides, sizes, walk):
    pl = ew.plan(shapes, strides)
    assert pl.shape == torch.broadcast_shapes(*shapes)
    assert pl.sizes == sizes and pl.strides == walk


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="broadcast"):
        ew.plan(((3,), (4,)), ((1,), (1,)))
    shape = (2,) * 7  # seven dims that do not merge: every other one permuted
    t = torch.empty(shape).permute(1, 0, 3, 2, 5, 4, 6)
    with pytest.raises(ValueError, match="dims"):
        ew.plan((shape, tuple(t.shape)), (torch.empty(shape).stride(), t.stride()))


def _layout(case, rng, dtype):
    """Operand trees for ``cmul`` (two complex ds) in a named layout."""
    c = lambda shape: ds.cds_from_f64(_values(rng, shape) + 1j * _values(rng, shape), dtype, "cpu")
    if case == "contiguous":
        return c((3, 4, 5)), c((3, 4, 5))
    if case == "broadcast":  # stride 0 on broadcast dims, no copy
        return c((3, 1, 5)), c((4, 1))
    if case == "expanded":
        x = c((1, 4, 5))
        return ds.tree_map(lambda a: a.expand(3, 4, 5), x), c((3, 4, 5))
    if case == "permuted":
        return ds.tree_map(lambda a: a.permute(2, 0, 1), c((4, 5, 3))), c((3, 4, 1))
    if case == "sliced":  # storage offsets, steps
        x = c((6, 9, 5))
        return ds.tree_map(lambda a: a[1:4, 2::2], x), c((5,))
    return c(()), c((2, 3))  # "scalar"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["contiguous", "broadcast", "expanded", "permuted", "sliced",
                                  "scalar"])
def test_cuda_wrapper_walks_the_kernels_indexing(monkeypatch, case, dtype):
    """The CUDA wrapper on CPU tensors, its library replaced by an entry
    that reads the table as the kernel does, walks every element with the
    kernel's index arithmetic over the raw memory and applies the plain
    chain: bitwise the plain chain on the operands, one launch counted."""
    seen = {}

    def entry(op, is_f64, args, blocks, stream):
        w = np.array(list(args), dtype=np.int64)
        k_in, k_out = ew.MAX_IN, ew.MAX_OUT
        ins, outs = w[:k_in], w[k_in:k_in + k_out]
        sizes = w[k_in + k_out:k_in + k_out + ew.MAX_DIMS]
        strides = w[k_in + k_out + ew.MAX_DIMS:-2].reshape(k_in, ew.MAX_DIMS)
        n, nd = int(w[-2]), int(w[-1])
        name = next(k for k, v in ew.OPS.items() if v[0] == op)
        _, n_in, n_out = ew.OPS[name]
        seen.update({"name": name, ("nd", name): nd, "blocks": blocks})
        assert 1 <= nd <= ew.MAX_DIMS and n == int(np.prod(sizes[:nd]))
        ctype = ctypes.c_double if is_f64 else ctypes.c_float
        rem = np.arange(n)
        off = np.zeros((n_in, n), dtype=np.int64)
        for d in range(nd - 1, 0, -1):  # the kernel's loop: inner dims, then the outermost
            c = rem % sizes[d]
            rem = rem // sizes[d]
            off += strides[:n_in, d, None] * c
        off += strides[:n_in, 0, None] * rem
        mem = lambda addr, count: np.ctypeslib.as_array(
            (ctype * int(count)).from_address(int(addr)))
        v = [torch.from_numpy(mem(ins[k], off[k].max() + 1)[off[k]].copy()) for k in range(n_in)]
        d_ = lambda i: ds.DS(v[i], v[i + 1])
        c_ = lambda i: ds.CDS(d_(i), d_(i + 2))
        args_ = {"cmul": lambda: (c_(0), c_(4)), "caxpy": lambda: (c_(0), c_(4), d_(8)),
                 "cadd_signed": lambda: (c_(0), c_(4), v[8])}[name]()
        for k, plane in enumerate(_leaves(getattr(ew, name + "_reference")(*args_))):
            mem(outs[k], n)[:] = plane.numpy()
        return 0

    monkeypatch.setattr(_build, "load_library",
                        lambda: types.SimpleNamespace(bfft_ds_elementwise=entry))
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(_build, "on_device", lambda d: contextlib.nullcontext())
    rng = np.random.default_rng(7)
    x, y = _layout(case, rng, dtype)
    w = ds.from_f64(_values(rng, (1,)), dtype, "cpu")
    pat = torch.as_tensor(_signs(rng, (5,) if case != "scalar" else ()))
    for name, args in (("cmul", (x, y)), ("caxpy", (y, x, w)), ("cadd_signed", (x, y, pat))):
        launches = ew.LAUNCHES[name]
        planes = {"cmul": ew._cds(x) + ew._cds(y), "caxpy": ew._cds(y) + ew._cds(x) + (w.hi, w.lo),
                  "cadd_signed": ew._cds(x) + ew._cds(y) + (pat,)}[name]
        got = ew._pack(ew._ds_elementwise_cuda(name, planes))
        want = getattr(ew, name + "_reference")(*args)
        assert ew.LAUNCHES[name] == launches + 1
        for g, r in zip(_leaves(got), _leaves(want)):
            assert g.shape == r.shape and g.dtype == r.dtype and g.is_contiguous()
            assert torch.equal(g, r), (name, case)
        assert seen["name"] == name and seen["blocks"] >= 1
    if case == "contiguous":
        assert seen[("nd", "cmul")] == seen[("nd", "caxpy")] == 1  # merged: no index divided


def test_ds_eval_and_rk4_reach_the_compositions():
    """The half-route ds eval (Hermitian finale) and a ds RK4 step on the
    CPU run the compositions at their call sites: the corrections' signed
    folds, the gain accumulation, the finale's signed add, the assembly and
    RK's axpys (7 a step)."""
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=2, impl="c2c", dtype="float32")
    pre = dso.build_ds_precomp(cfg, device="cpu")
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, "cpu")
    before = dict(ew.REFERENCE_CALLS)
    q = dso.collide_ds(cfg, pre, f, contract="oz", g_stream="half", herm_downstream=True)
    calls = {k: ew.REFERENCE_CALLS[k] - before[k] for k in ew.OPS}
    n_gl = pre.gain_w.hi.shape[0]
    assert calls["cadd_signed"] == 2 * 4  # four folds per stream
    assert calls["caxpy"] == n_gl and calls["sub_mul"] == 1 and calls["add_signed"] == 1
    assert calls["cmul"] == 2 * (3 * 3 + 3 * 2 + 1)  # planes 3 each, lines 2, the corner
    assert np.isfinite(ds.to_f64(q)).all()
    before = ew.REFERENCE_CALLS["axpy"]
    rhs = lambda x: ds.DS(0.5 * x.hi, 0.5 * x.lo)
    bt.rk4_step(rhs, f, 0.25)
    assert ew.REFERENCE_CALLS["axpy"] - before == 7


@pytest.mark.parametrize("steps, group_batch, sub_batch", [(1, 1, 2), (3, 1, 4), (1, 2, 2)])
def test_half_path_lays_its_tables_out_per_chunk_of_steps(monkeypatch, steps, group_batch,
                                                          sub_batch):
    """The half path's main-block tables laid out a chunk of radial steps at
    a time (``ds_operator.LAYOUT_STEPS``; ragged last chunks, ragged node
    cuts, two groups a step) give the bits of one layout of all steps."""
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c", dtype="float32")
    pre = dso.build_ds_precomp(cfg, device="cpu")
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, "cpu")
    kw = dict(contract="oz", g_stream="half", group_batch=group_batch, sub_batch=sub_batch)
    assert pre.gain_w.hi.shape[0] // group_batch <= dso.LAYOUT_STEPS
    want = dso.collide_ds(cfg, pre, f, **kw)
    monkeypatch.setattr(dso, "LAYOUT_STEPS", steps)
    got = dso.collide_ds(cfg, pre, f, **kw)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
