"""``boltzfft_torch.examples``: each example's ``main`` at tiny sizes with
``--device cpu``, its printed numbers held to the JAX package's at the same
sizes (the JAX examples' own lines, or the JAX functions they call), and the
spatial examples' sharded runs (a 1-rank mesh here, 2 and 4 gloo ranks
through ``tests/torch_rank_worker.py``) line for line equal to the
unsharded one.
"""

import contextlib
import functools
import importlib
import importlib.util
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch.examples import (
    adjoint_fit,
    bkw_relaxation,
    convergence_study,
    mixing_2d3v,
    ozaki_contraction,
    precision_ladder,
    taylor_green_2d3v,
)
from boltzfft_torch.examples._mesh import mesh_dims

JAX_EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The examples' many small ops: under xdist, beside the other test
    workers, torch's thread pool stalls them (the sharded mixing run took
    minutes there, 2 s alone); one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_examples_{name}",
                                                  JAX_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def _lines(capsys):
    return _split(capsys.readouterr().out)


def _printed(fn, *args):
    """``fn(*args)``'s return value and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, _split(buf.getvalue())


# the flag of each spatial example's unsharded run
LOCAL_FLAG = {"mixing_2d3v": (), "taylor_green_2d3v": ("--local",)}


@functools.lru_cache(maxsize=None)
def _local(name, *argv):
    """The lines of an example's unsharded run on the CPU; ``NAME=value``
    arguments set the module's constants (``mixing_2d3v.CELLS``) for the
    call."""
    mod = importlib.import_module(f"boltzfft_torch.examples.{name}")
    consts = {k: int(v) for k, v in (a.split("=") for a in argv if "=" in a)}
    saved = {k: getattr(mod, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(mod, k, v)
        rc, lines = _printed(mod.main, [a for a in argv if "=" not in a]
                             + list(LOCAL_FLAG[name]) + CPU)
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    assert rc == 0
    return lines


def _jax_mixing_lines(cells, steps, monkeypatch):
    """The JAX mixing example's lines at ``cells`` per axis and ``steps``
    steps: its own source, with its constants (12 and 8) set to these."""
    path = JAX_EXAMPLES / "mixing_2d3v.py"
    src = path.read_text()
    for old, new in (("    nx = ny = 12\n", f"    nx = ny = {cells}\n"),
                     ("    steps = 8\n", f"    steps = {steps}\n")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    ns = {"__name__": "jax_examples_mixing_2d3v", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    monkeypatch.setattr(sys, "argv", [str(path)])
    rc, lines = _printed(ns["main"])
    assert rc == 0
    return lines


def test_ozaki_contraction_prints_the_jax_lines(capsys):
    assert ozaki_contraction.main(CPU) is None
    got = _lines(capsys)
    rel = float(got[1].split(":")[1])
    assert rel <= 1e-13
    assert _jax_example("ozaki_contraction").main() is None
    assert got == _lines(capsys)


def test_convergence_study_rows_match_jax(capsys):
    assert convergence_study.main(["--max-nv", "8", "--Ns", "6"] + CPU) is None
    got = _lines(capsys)
    assert _jax_example("convergence_study").main(["--max-nv", "8", "--Ns", "6"]) is None
    want = _lines(capsys)
    assert got[1].split()[0] == "8" and got == want  # the rows at 4 significant digits


def test_bkw_relaxation_moments_match_jax(capsys, monkeypatch):
    import jax.numpy as jnp

    import boltzfft as bz

    runs = []
    make = bt.make_relaxation

    def recording(*a, **kw):
        run = make(*a, **kw)
        return lambda f0: runs.append(run(f0)) or runs[-1]

    monkeypatch.setattr(bt, "make_relaxation", recording)
    assert bkw_relaxation.main(["--Nv", "8", "--Ns", "6", "--steps", "2"] + CPU) is None
    out = capsys.readouterr().out
    assert "BKW relaxation, Nv=8, Ns=6" in out and "Linf vs analytic BKW" in out
    got = runs[0].recorded

    cfg = bz.CollisionConfig(nv=8, ns=6)
    collide, pre = bz.make_collision_operator(cfg)
    g = cfg.velocity_grid
    v = jnp.asarray(g.v, cfg.real_dtype)
    f0 = jnp.asarray(np.asarray(bz.bkw_f(g.r_squared(), 5.5)), cfg.real_dtype)
    want = bz.make_relaxation(collide, pre, dt=0.25, n_steps=2, method="rk4",
                              record=lambda f: bz.moments(f, v, g.dv))(f0).recorded
    for name in ("mass", "energy", "temperature"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-12)


def test_adjoint_fit_first_gradient_matches_jax(capsys, monkeypatch):
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    grads = []
    step = torch.optim.Adam.step

    def recording(self, *a, **kw):
        grads.append(float(self.param_groups[0]["params"][0].grad))
        return step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", recording)
    rc = adjoint_fit.main(["--Nv", "8", "--steps", "3"] + CPU)
    assert rc in (0, 1) and len(grads) == 3
    assert "recovered T" in capsys.readouterr().out

    cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="rfft", dtype="float32")
    collide, pre = bz.make_collision_operator(cfg, jit=False)
    rsq = jnp.asarray(cfg.velocity_grid.r_squared(), jnp.float32)
    maxw = lambda t: (1.0 / (2.0 * jnp.pi * t) ** 1.5) * jnp.exp(-rsq / (2.0 * t))  # noqa: E731
    q_obs = collide(maxw(1.3), pre)
    loss = lambda t: jnp.sum((collide(maxw(t), pre) - q_obs) ** 2)  # noqa: E731
    want = float(jax.grad(loss)(jnp.asarray(0.7, jnp.float32)))
    assert abs(grads[0] - want) <= 1e-5 * abs(want)


def test_precision_ladder_prints_every_row(capsys):
    """Every row, its L-inf against BKW equal to JAX's example at 4
    significant digits (the method's error at 8^3), its error against the
    ds oracle (float32 rounding, in another order of operations) within 5%
    of JAX's."""
    argv = ["--Nv", "8", "--Ns", "6"]
    assert precision_ladder.main(argv + CPU) == 0
    rows = {ln[:16].strip(): ln[16:].split() for ln in _lines(capsys)}
    assert _jax_example("precision_ladder").main(argv) == 0
    want = {ln[:16].strip(): ln[16:].split() for ln in _lines(capsys)}
    for name in ("fused default", "fused highest", "rfft", "ds (compensated)"):
        linf = float(rows[name][0])
        assert np.isfinite(linf) and linf < 1e-3, (name, rows[name])
        assert rows[name][0] == want[name][0], (name, rows[name], want[name])
        if name == "ds (compensated)":
            assert rows[name][1] == want[name][1] == "oracle"
        else:
            np.testing.assert_allclose(float(rows[name][1]), float(want[name][1]), rtol=0.05)


def _without_mesh_line(lines):
    return [ln for ln in lines
            if not ln.startswith(("spatial decomposition", "unsharded solver"))]


def test_mixing_2d3v_lines_match_jax(monkeypatch):
    assert _local("mixing_2d3v", "CELLS=8", "STEPS=2") == _jax_mixing_lines(8, 2, monkeypatch)


def test_taylor_green_lines_match_jax():
    argv = ("--cells", "4", "--nv", "8", "--steps", "2")
    rc, want = _printed(_jax_example("taylor_green_2d3v").main, [*argv, "--local"])
    assert rc == 0 and _local("taylor_green_2d3v", *argv) == want


def test_mixing_2d3v_sharded_lines_equal_local(capsys, monkeypatch):
    monkeypatch.setattr(mixing_2d3v, "CELLS", 8)
    monkeypatch.setattr(mixing_2d3v, "STEPS", 2)
    assert mixing_2d3v.main(CPU) == 0
    local = _lines(capsys)
    assert mixing_2d3v.main(["--shard"] + CPU) == 0
    sharded = _lines(capsys)
    assert sharded[0] == "spatial decomposition: 1x1 device mesh, 8x8 cells per shard"
    assert "2D×3V mixing: 8x8 cells" in local[0] and sharded[1:] == local


def test_taylor_green_sharded_lines_equal_local(capsys):
    argv = ["--cells", "4", "--nv", "8", "--steps", "2"] + CPU
    assert taylor_green_2d3v.main(argv + ["--local"]) == 0
    local = _lines(capsys)
    assert taylor_green_2d3v.main(argv) == 0
    sharded = _lines(capsys)
    assert local[0] == "unsharded solver: 4x4 cells"
    assert sharded[0] == "spatial decomposition: 1x1 device mesh, 4x4 cells per shard"
    assert _without_mesh_line(sharded) == _without_mesh_line(local)
    assert "vortex decayed" in local[-1]


# The sharded spatial examples on 2 and 4 gloo ranks (tests/torch_rank_worker.py):
# rank 0 prints its mesh line and then the unsharded run's lines, the other
# ranks print nothing.  Four ranks split 6 cells 2x2 and 8 cells 4x1.
RANKED = {  # case -> (ranks, example, its arguments, its mesh)
    "mixing-2": (2, "mixing_2d3v", ("CELLS=8", "STEPS=2"), "2x1 device mesh, 4x8"),
    "mixing-4": (4, "mixing_2d3v", ("CELLS=6", "STEPS=2"), "2x2 device mesh, 3x3"),
    "tg-2": (2, "taylor_green_2d3v", ("--cells", "4", "--nv", "8", "--steps", "2"),
             "2x1 device mesh, 2x4"),
    "tg-4": (4, "taylor_green_2d3v", ("--cells", "8", "--nv", "8", "--steps", "2"),
             "4x1 device mesh, 2x8"),
}


def _ranked_case(key):
    _, name, argv, _ = RANKED[key]
    shard = ("--shard",) if name == "mixing_2d3v" else ()
    return ":".join(("example", name, *argv, *shard, *CPU))


@pytest.fixture(scope="module")
def ranked_runs(tmp_path_factory):
    from torch_rank_worker import launch

    tmp = tmp_path_factory.mktemp("ranks")
    out = {}
    for world in sorted({w for w, *_ in RANKED.values()}):
        keys = [k for k, v in RANKED.items() if v[0] == world]
        res = launch(world, [_ranked_case(k) for k in keys], tmp)
        for k in keys:
            out[k] = [r[_ranked_case(k)] for r in res]
    return out


@pytest.mark.parametrize("key", list(RANKED))
def test_sharded_examples_on_ranks_equal_local(ranked_runs, key):
    world, name, argv, mesh = RANKED[key]
    runs = ranked_runs[key]
    assert [r["rc"] for r in runs] == [0] * world
    assert all(r["out"] == "" for r in runs[1:])  # rank 0 prints
    got = _split(runs[0]["out"])
    assert f"spatial decomposition: {mesh} cells per shard" in got
    assert _without_mesh_line(got) == _without_mesh_line(_local(name, *argv))


@pytest.mark.parametrize("n_ranks,cells,dims", [
    (1, 12, (1, 1)), (2, 12, (2, 1)), (4, 12, (4, 1)), (8, 12, (4, 2)), (4, 6, (2, 2)),
])
def test_mesh_dims_follow_the_jax_rule(n_ranks, cells, dims):
    assert mesh_dims(n_ranks, cells) == dims


@pytest.mark.parametrize("mod", [ozaki_contraction, bkw_relaxation, convergence_study,
                                 precision_ladder, adjoint_fit, mixing_2d3v,
                                 taylor_green_2d3v])
def test_examples_default_to_the_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
