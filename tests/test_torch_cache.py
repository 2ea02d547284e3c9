"""``boltzfft_torch.save_precomp`` / ``load_precomp`` against the JAX
package's ``boltzfft.save_precomp`` / ``load_precomp``: the port's own round
trip (bitwise), archives crossing both ways (within 1e-12 max|Q| in
float64, 16^3 / Ns=6 on rfft and dft), and the config keys the port drops,
rejects or defaults.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import cache

CPU = torch.device("cpu")
TOL = 1e-12  # |port - JAX| in units of max|Q|, float64


def _cfg(**kw):
    kw.setdefault("nv", 16)
    kw.setdefault("ns", 6)
    return bt.CollisionConfig(**kw)


def _f(cfg):
    return torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype)


def _fields(pre):
    return {f.name: getattr(pre, f.name) for f in dataclasses.fields(bt.Precomp)}


@pytest.mark.parametrize("impl,dtype", [("rfft", "float64"), ("dft", "float64"),
                                        ("rfft", "float32"), ("fused", "float32")])
def test_roundtrip_is_bitwise(tmp_path, impl, dtype):
    cfg = _cfg(nv=8, impl=impl, dtype=dtype)
    pre = bt.build_precomp(cfg, CPU)
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, pre)
    cfg2, pre2 = bt.load_precomp(path, device="cpu")
    assert cfg2 == cfg
    assert pre2.derived == {}
    for name, a in _fields(pre).items():
        b = getattr(pre2, name)
        if a is None:
            assert b is None
        else:
            assert b.dtype == a.dtype and b.device == CPU and torch.equal(a, b), name


@pytest.mark.parametrize("impl", ["rfft", "dft"])
def test_loaded_precomp_computes_the_same_q(tmp_path, impl):
    cfg = _cfg(nv=8, impl=impl)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f = _f(cfg)
    q1 = collide(f, pre)
    assert pre.derived  # the settled chunk stays with the original
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, pre)
    cfg2, pre2 = bt.load_precomp(path, device="cpu")
    assert pre2.derived == {}
    assert torch.equal(bt.collide(cfg2, pre2, f), q1)


def _jax_q(bz, cfg_j, pre_j, f):
    import jax

    return np.asarray(jax.jit(lambda x, p: bz.collide(cfg_j, p, x))(f, pre_j))


@pytest.mark.parametrize("impl", ["rfft", "dft"])
def test_jax_archive_loads_in_the_port(tmp_path, impl):
    import boltzfft as bz

    cfg_j = bz.CollisionConfig(nv=16, ns=6, impl=impl)
    pre_j = bz.build_precomp(cfg_j)
    path = tmp_path / "jax.npz"
    bz.save_precomp(path, cfg_j, pre_j)
    cfg, pre = bt.load_precomp(path, device="cpu")
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(cfg_j).items()
    f = _f(cfg)
    want = _jax_q(bz, cfg_j, pre_j, f.numpy())
    got = bt.collide(cfg, pre, f).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("impl", ["rfft", "dft"])
def test_port_archive_loads_in_jax(tmp_path, impl):
    import boltzfft as bz

    cfg = _cfg(impl=impl)
    pre = bt.build_precomp(cfg, CPU)
    path = tmp_path / "port.npz"
    bt.save_precomp(path, cfg, pre)
    cfg_j, pre_j = bz.load_precomp(path)
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(cfg_j).items()
    f = _f(cfg)
    want = bt.collide(cfg, pre, f).numpy()
    got = _jax_q(bz, cfg_j, pre_j, f.numpy())
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _rewrite_config(path, edit):
    """The archive at ``path`` with its ``__config__`` JSON edited."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__config__"}
        data = json.loads(str(z["__config__"]))
    edit(data)
    np.savez_compressed(path, __config__=json.dumps(data), **arrays)


def test_tpu_fields_are_dropped(tmp_path):
    cfg = _cfg(nv=8)
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, bt.build_precomp(cfg, CPU))
    _rewrite_config(path, lambda d: d.update(fused_nodes_per_step=48, fused_radix=4,
                                             fused_sub_batch=2))
    cfg2, _ = bt.load_precomp(path, device="cpu")
    assert cfg2 == cfg
    assert set(cache.TPU_FIELDS) == {"fused_nodes_per_step", "fused_radix", "fused_sub_batch"}


def test_unknown_key_raises(tmp_path):
    cfg = _cfg(nv=8)
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, bt.build_precomp(cfg, CPU))
    _rewrite_config(path, lambda d: d.update(no_such_field=1))
    with pytest.raises(TypeError, match="no_such_field"):
        bt.load_precomp(path, device="cpu")


def test_missing_antipodal_reads_false(tmp_path):
    cfg = _cfg(nv=8, antipodal=False)
    pre = bt.build_precomp(cfg, CPU)
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, pre)
    _rewrite_config(path, lambda d: d.pop("antipodal"))
    cfg2, pre2 = bt.load_precomp(path, device="cpu")
    assert cfg2.antipodal is False and cfg2 == cfg
    assert pre2.rho.shape[0] == cfg2.n_nodes_padded(CPU)


def test_load_defaults_to_the_card(tmp_path):
    assert inspect.signature(bt.load_precomp).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default has nothing to refuse")
    cfg = _cfg(nv=8)
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, bt.build_precomp(cfg, CPU))
    with pytest.raises(RuntimeError, match="cuda"):
        bt.load_precomp(path)
