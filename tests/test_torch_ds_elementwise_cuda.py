"""The ds engine's fused elementwise kernels (``csrc/ds_elementwise.cu``) on a
card, each against its plain chain (``kernels.ds_elementwise.plain_chains``)
on the same CUDA tensors; every comparison is bitwise (on the bit patterns,
so NaNs from an overflowing split compare too).

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ds_elementwise_cuda.py -m cuda

Without a card every test skips.
"""

import contextlib

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import ds
from boltzfft_torch.kernels import ds_elementwise as ew


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# the operands' kinds per chain: "d" ds, "c" complex ds, "f" a plain float, "p"
# a sign pattern
KINDS = {
    "add": "dd", "sub": "dd", "mul": "dd", "mul_f": "df", "cadd": "cc", "cmul": "cc",
    "cmul_ds": "cd", "cmul_both": "cc", "axpy": "ddd", "caxpy": "ccd", "sub_mul": "ddd",
    "cadd_signed": "ccp", "add_signed": "ddp",
}
# (first operand's shape, the others' shapes, a transform of the first operand)
LAYOUTS = {
    "ragged": ((1031,), (1031,), None),  # not a multiple of the 256-thread block
    "broadcast": ((5, 7, 33), (7, 1), None),  # stride 0 on broadcast dims
    "strided": ((9, 8, 37), (4, 9), lambda a: a.transpose(0, 2)[:, 1::2]),  # permuted, stepped
}


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _leaves(tree):
    out = []
    ds.tree_map(out.append, tree)
    return out


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _operands(name, make, shapes, dtype, dev, rng):
    """The chain's operands from ``make(shape) -> host float64 array``."""
    out = []
    for kind, shape in zip(KINDS[name], shapes):
        t = lambda: torch.as_tensor(make(shape), dtype=dtype, device=dev)
        if kind == "d":
            out.append(ds.DS(t(), t()))
        elif kind == "c":
            out.append(ds.CDS(ds.DS(t(), t()), ds.DS(t(), t())))
        elif kind == "f":
            out.append(t())
        else:
            out.append(torch.as_tensor(rng.choice([-1.0, 1.0], shape), dtype=torch.float32,
                                       device=dev))
    return out


def _check(name, args):
    launches = ew.LAUNCHES[name]
    got = getattr(ds, name)(*args)
    assert ew.LAUNCHES[name] == launches + 1
    with ew.plain_chains():
        calls = ew.REFERENCE_CALLS[name]
        want = getattr(ds, name)(*args)
        assert ew.REFERENCE_CALLS[name] == calls + 1
    torch.cuda.synchronize()
    assert _same_bits(got, want), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_kernel_bitwise_against_its_plain_chain(cuda_device, name, dtype, layout):
    rng = np.random.default_rng(len(name))
    first, rest, view = LAYOUTS[layout]
    make = lambda shape: rng.standard_normal(shape) * 2.0 ** rng.uniform(-30, 30, shape)
    shapes = [first] + [rest] * (len(KINDS[name]) - 1)
    args = _operands(name, make, shapes, dtype, cuda_device, rng)
    if view is not None:
        args[0] = ds.tree_map(view, args[0])
    _check(name, args)


def _special(dtype, shape, rng):
    """Signed zeros, subnormals, tiny and huge normals and values on both
    sides of ``split``'s overflow edge (max / (2^ceil(p/2) + 1))."""
    fi = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    edge = float(fi.max) / (4097.0 if dtype == torch.float32 else 134217729.0)
    pool = np.array([0.0, -0.0, float(fi.smallest_subnormal), -3.0 * float(fi.smallest_subnormal),
                     float(fi.tiny) * 0.75, float(fi.tiny), 1.0, -1.5, edge * 0.999, -edge * 0.999,
                     edge * 1.001, float(fi.max) * 0.5, 2.0 ** 60, -2.0 ** -60])
    return rng.choice(pool, shape) * rng.choice([1.0, 0.5, 3.0], shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_kernel_bitwise_on_special_values(cuda_device, name, dtype):
    rng = np.random.default_rng(99)
    shapes = [(4099,)] * len(KINDS[name])
    with np.errstate(over="ignore"):
        args = _operands(name, lambda shape: _special(dtype, shape, rng), shapes, dtype,
                         cuda_device, rng)
    _check(name, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mul_f_python_scalar_launches_the_kernel(cuda_device, dtype):
    """A Python scalar is a float of the pairs' dtype: one launch, the
    plain chain's bits."""
    rng = np.random.default_rng(3)
    x = ds.DS(*(torch.as_tensor(rng.standard_normal(1031), dtype=dtype, device=cuda_device)
                for _ in range(2)))
    got = _check("mul_f", [x, 1e-3])
    assert _same_bits(got, ds.mul_f(x, torch.tensor(1e-3, dtype=dtype, device=cuda_device)))


@pytest.mark.cuda
def test_mixed_dtypes_raise(cuda_device):
    x = ds.from_f64(np.ones(8), torch.float32, cuda_device)
    y = ds.from_f64(np.ones(8), torch.float64, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        ds.add(x, y)


def _ds_cfg(n):
    return bt.CollisionConfig(nv=n, ns=12, impl="c2c", dtype="float32")


@pytest.mark.cuda
@pytest.mark.parametrize("jit", [False, True])
def test_ds_eval_16_bitwise_against_the_plain_chains(cuda_device, jit):
    """The card's default ds eval at 16^3 (replayed from a graph or eager)
    gives the bits of the same eval with every elementwise chain plain, and
    launches the fused kernels (none under the plain context)."""
    cfg = _ds_cfg(16)
    op, pre = bt.make_ds_collision_operator(cfg, jit=jit, device=cuda_device)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, cuda_device)
    before = sum(ew.LAUNCHES.values())
    q = op(f, pre)
    assert sum(ew.LAUNCHES.values()) > before
    with ew.plain_chains():
        op_p, _ = bt.make_ds_collision_operator(cfg, jit=jit, device=cuda_device)
        before = sum(ew.LAUNCHES.values())
        q_p = op_p(f, pre)
        assert sum(ew.LAUNCHES.values()) == before
    torch.cuda.synchronize()
    assert _same_bits(q, q_p)
    assert _same_bits(op(f, pre), q)


@pytest.mark.cuda
def test_ds_rk4_step_graph_bitwise_against_the_plain_chains(cuda_device):
    """Two ds RK4 steps of ``make_relaxation(jit=True)`` at 16^3 (one CUDA
    graph a step, the fused axpys inside it) against the same run with the
    plain chains, bitwise on the final state."""
    cfg = _ds_cfg(16)
    f0 = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 5.5), torch.float32, cuda_device)
    runs = {}
    for plain in (False, True):
        with ew.plain_chains() if plain else contextlib.nullcontext():
            op, pre = bt.make_ds_collision_operator(cfg, device=cuda_device)
            run = bt.make_relaxation(op, pre, dt=0.25, n_steps=2, method="rk4", jit=True)
            axpys = ew.LAUNCHES["axpy"]
            runs[plain] = run(f0).f
            # warm-up and capture of the step's graph: 7 axpys each, a replay none
            assert ew.LAUNCHES["axpy"] - axpys == (0 if plain else 14)
    torch.cuda.synchronize()
    assert _same_bits(runs[False], runs[True])

