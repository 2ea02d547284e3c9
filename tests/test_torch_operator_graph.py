"""``make_collision_operator(cfg, jit=True, *, device="cuda")`` on the CPU:
its signature against the JAX package's, ``jit`` changing nothing off the
card, the node chunk settled once per precomp (and still JAX's on the CPU),
the K3 tables held by a graph being captured, and K6's launch plan and its
entry's ctypes signature (pure Python: the kernel itself runs only on a
card, see ``test_torch_operator_graph_cuda.py``)."""

import ctypes
import inspect
import re

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _build, _graph
from boltzfft_torch import operator as bt_op
from boltzfft_torch import weights as bt_weights
from boltzfft_torch.kernels import alpha_multiply as k6
from boltzfft_torch.kernels import gain_reduce as k5


def _jax():
    import jax.numpy as jnp

    import boltzfft as bz

    return jnp, bz


def test_signature_follows_the_jax_factory():
    _, bz = _jax()
    ps = list(inspect.signature(bt.make_collision_operator).parameters.values())
    pj = list(inspect.signature(bz.make_collision_operator).parameters.values())
    assert [p.name for p in ps[:2]] == [p.name for p in pj[:2]] == ["cfg", "jit"]
    assert ps[1].default is True and pj[1].default is True
    assert ps[2].name == "device" and ps[2].kind is inspect.Parameter.KEYWORD_ONLY
    assert ps[2].default == "cuda" and len(ps) == 3


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        bt.make_collision_operator(bt.CollisionConfig(nv=8, ns=6, impl="rfft"))


ROUTES = [
    dict(impl="rfft", use_pallas=True),
    dict(impl="rfft"),
    dict(impl="c2c"),
    dict(impl="dft"),
    dict(impl="fused", fused_scheme="ct"),
    dict(impl="fused", fused_scheme="kron"),
    dict(impl="fused", fused_scheme="transpose"),
]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("kw", ROUTES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_jit_changes_nothing_on_the_cpu(kw, batch):
    cfg = bt.CollisionConfig(nv=8, ns=6, **kw)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    if batch:
        f = torch.stack([f * (1.0 - 0.1 * i) for i in range(batch)])
    collide_j, pre_j = bt.make_collision_operator(cfg, device="cpu")
    collide_e, pre_e = bt.make_collision_operator(cfg, jit=False, device="cpu")
    q = collide_j(f, pre_j)
    assert torch.equal(q, collide_e(f, pre_e))
    assert torch.equal(q, collide_j(f, pre_j))
    assert q.shape == f.shape


def test_node_chunk_is_settled_once_per_precomp(monkeypatch):
    """The staged chunk is read at the first call and kept: a budget that
    moves between calls (the card's free memory does) changes neither the
    chunks nor the bits; a fresh precomp reads it again.  On the CPU the
    settled chunk and the node padding are the JAX package's."""
    _, bz = _jax()
    kw = dict(nv=8, ns=6, impl="rfft", use_pallas=True)
    cfg = bt.CollisionConfig(**kw)
    cfg_j = bz.CollisionConfig(**kw)
    pre_j = bz.build_precomp(cfg_j)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    b = pre.rho.shape[0]
    assert b == pre_j.rho.shape[0]
    want = min(cfg_j.chunk, b)
    while b % want:
        want -= 1
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    calls = k5.REFERENCE_CALLS
    q = collide(f, pre)
    assert k5.REFERENCE_CALLS - calls == b // want
    assert bt_op.node_chunk(cfg, pre) == want == b
    # a budget of five nodes' working set: cfg.chunk moves, the settled chunk does not
    per_node = 9 * 8 * 8 * 5 * 16
    monkeypatch.setattr(bt_weights, "_device_hbm_budget", lambda device: 5 * per_node)
    assert cfg.chunk("cpu") == 5
    calls = k5.REFERENCE_CALLS
    assert torch.equal(collide(f, pre), q)
    assert k5.REFERENCE_CALLS - calls == 1 and bt_op.node_chunk(cfg, pre) == b
    fresh = bt.build_precomp(cfg, "cpu")
    assert bt_op.node_chunk(cfg, fresh) == 5 and fresh.rho.shape[0] == 25
    assert bt_op.kernel_chunk(cfg, pre, f) is None  # no kernel chunk off the card


def test_kron_tables_are_held_by_a_capture():
    """A replay reads K3's tables in place: while a graph is captured, the
    tables the eval takes from ``pre.derived`` go to ``_graph.hold``, so a
    cleared ``pre.derived`` never frees them."""
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="kron")
    pre = bt.build_precomp(cfg, "cpu")
    _graph._held = held = []
    try:
        tables = bt_op._kron_tables(cfg, pre)
    finally:
        _graph._held = None
    assert held == [tables] and bt_op._kron_tables(cfg, pre) is tables
    pre.derived.clear()
    assert bt_op._kron_tables(cfg, pre) is not tables


# --------------------------------------------------------------------------
# K6's launch plan and entry
# --------------------------------------------------------------------------


def _k6_cover(p: k6.Plan, b: int, n: int, m2: int) -> np.ndarray:
    """How often the kernel's threads write each (node, flattened mode):
    thread (bx, t) of node block by owns p = (bx * threads + t) * vec and
    its vec neighbours, split once into (i, m), for the nodes of its block."""
    q = np.arange(p.xblocks * p.threads) * p.vec
    q = q[q < n * m2]
    i, m = q // m2, q % m2
    assert (m + p.vec <= m2).all() and (i * m2 + m == q).all()  # a vector stays in its row
    hits = np.zeros((b, n * m2), np.int64)
    for by in range(p.node_blocks):
        for k in range(p.vec):
            hits[by * p.nb:min(by * p.nb + p.nb, b), q + k] += 1
    return hits


@pytest.mark.parametrize("b,n,m2,itemsize,aligned", [
    (192, 32, 32 * 17, 8, True),   # 32^3 float32: the route's chunk
    (192, 32, 32 * 17, 16, True),  # 32^3 float64
    (384, 64, 64 * 33, 8, True),   # 64^3 float32
    (384, 64, 64 * 33, 16, True),  # 64^3 float64
    (6, 8, 40, 8, True),           # ragged: one partial tile
    (7, 5, 15, 8, True),           # odd M2: scalar accesses in float
    (70001, 2, 6, 8, True),        # past one grid's node blocks: two nodes a thread
    (50, 16, 16 * 9, 8, False),    # operands off 16-byte alignment
])
def test_k6_plan_covers_every_output_once(b, n, m2, itemsize, aligned):
    p = k6.plan(b, n, m2, itemsize, aligned)
    assert p.vec == (2 if itemsize == 8 and m2 % 2 == 0 and aligned else 1)
    assert p.threads == k6.THREADS and p.node_blocks == -(-b // p.nb)
    # one node a thread, more only where the grid's y limit forces it
    assert p.node_blocks <= k6.MAX_NODE_BLOCKS
    assert p.nb == 1 or -(-b // (p.nb // 2)) > k6.MAX_NODE_BLOCKS
    assert (_k6_cover(p, b, n, m2) == 1).all()


def test_k6_plan_on_the_main_path():
    """The route's chunks: 16-byte vectors in float, one node a thread."""
    assert k6.plan(192, 32, 544, 8, True) == (2, 256, 1, 34, 192)
    assert k6.plan(192, 32, 544, 16, True) == (1, 256, 1, 68, 192)
    assert k6.plan(384, 64, 2112, 8, True) == (2, 256, 1, 264, 384)
    assert k6.plan(384, 64, 2112, 16, True) == (1, 256, 1, 528, 384)
    assert k6.plan(70001, 2, 6, 8, True).nb == 2


def test_k6_entry_signature_matches_the_source():
    """The ctypes argtypes of K6's entries are the macro's C parameters, one
    for one (a short list would pass the stream through garbage)."""
    text = (_build._SRC_DIR / "alpha_multiply.cu").read_text()
    m = re.search(r'extern "C" int NAME\(([^)]*)\)', text)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    params = [re.sub(r"\bconst\b|\w+$", "", p.strip()).replace(" ", "")
              for p in m.group(1).replace("\\", "").split(",")]
    assert [kinds[t] for t in params] == _build._ENTRY_ARGS["bfft_alpha_multiply"]
    assert "BFFT_ALPHA_ENTRY(bfft_alpha_multiply_f32" in text
    assert "BFFT_ALPHA_ENTRY(bfft_alpha_multiply_f64" in text
