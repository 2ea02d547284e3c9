"""``boltzfft_torch.tune`` (the autotuners) on the CPU, mirroring
``tests/test_tune.py`` with a patched timer, plus real probes at 8^3 whose
tuned operator is held to the JAX package's Q (1e-12 max|Q| in float64: the
node chunk sets the order of the node sum, so a tuned operator is held to a
tolerance, not to bits).
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import tune

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_memo():
    tune._MEMO.clear()
    yield
    tune._MEMO.clear()


def _staged(**kw):
    kw.setdefault("nv", 8)
    kw.setdefault("ns", 6)
    kw.setdefault("n_radial", 4)
    kw.setdefault("impl", "rfft")
    return bt.CollisionConfig(**kw)


def _oom(what="candidate"):
    return torch.cuda.OutOfMemoryError(f"CUDA out of memory ({what})")


class TestAutotune:
    def test_picks_fastest_memoizes_and_keeps_wisdom(self, monkeypatch, tmp_path):
        cfg = _staged()
        times = {3: 2.0, 6: 0.5, 12: 1.0}
        calls = []

        def fake_time(trial_cfg, k, trials, *, device):
            calls.append(trial_cfg.node_chunk)
            assert torch.device(device) == CPU
            return times[trial_cfg.node_chunk]

        monkeypatch.setattr(tune, "_time_candidate", fake_time)
        wisdom = tmp_path / "wisdom.json"
        tuned = bt.autotune(cfg, candidates=[3, 6, 12], cache_file=str(wisdom), device="cpu")
        assert tuned.node_chunk == 6 and calls == [3, 6, 12]
        assert dataclasses.replace(tuned, node_chunk=None) == cfg

        calls.clear()  # memoized: no further probing
        assert bt.autotune(cfg, candidates=[3], device="cpu").node_chunk == 6
        assert calls == []

        tune._MEMO.clear()  # the wisdom file survives a fresh process
        assert bt.autotune(cfg, candidates=[3], cache_file=str(wisdom),
                           device="cpu").node_chunk == 6
        assert calls == []
        store = json.loads(wisdom.read_text())
        assert list(store.values()) == [6]
        assert "/".join(map(str, tune._chunk_key(cfg, CPU))) in store

    def test_default_candidates_are_settled_chunks(self, monkeypatch):
        cfg = _staged(n_radial=5)  # 15 nodes: 3, 7 and 15, each padding the tables its own way
        from boltzfft_torch import operator as op

        cands = tune._chunk_candidates(cfg, CPU)
        settled = [op.node_chunk_for(dataclasses.replace(cfg, node_chunk=c), CPU)
                   for c in cands]
        assert len(set(settled)) == len(settled) >= 2
        assert cfg.auto_chunk(CPU) in cands or cfg.n_nodes in cands
        # the settled chunk is the one the operator runs
        for c, s in zip(cands, settled):
            trial = dataclasses.replace(cfg, node_chunk=c)
            assert op.node_chunk(trial, bt.build_precomp(trial, CPU)) == s

    def test_keys_carry_device_kind_and_use_pallas(self):
        a = tune._chunk_key(_staged(), CPU)
        b = tune._chunk_key(_staged(use_pallas=True), CPU)
        assert a != b and a[-1] == b[-1] == "cpu"
        assert tune._ds_key(_staged(), "vpu", CPU)[-1] == "cpu"

    def test_oom_candidate_is_skipped(self, monkeypatch, capsys):
        def fake_time(trial_cfg, k, trials, *, device):
            if trial_cfg.node_chunk == 12:
                raise _oom()
            return float(trial_cfg.node_chunk)

        monkeypatch.setattr(tune, "_time_candidate", fake_time)
        tuned = bt.autotune(_staged(), candidates=[12, 6], verbose=True, device="cpu")
        assert tuned.node_chunk == 6
        assert "node_chunk=12 does not fit" in capsys.readouterr().out

    def test_other_errors_raise(self, monkeypatch):
        def fake_time(trial_cfg, k, trials, *, device):
            raise RuntimeError("the kernel failed to launch")

        monkeypatch.setattr(tune, "_time_candidate", fake_time)
        with pytest.raises(RuntimeError, match="failed to launch"):
            bt.autotune(_staged(), candidates=[6], device="cpu")
        assert tune._MEMO == {}

    def test_fused_goes_to_autotune_fused(self, monkeypatch):
        monkeypatch.setattr(tune, "_time_candidate", lambda *a, **k: pytest.fail("probed"))
        cfg = _staged(impl="fused")
        assert bt.autotune(cfg, device="cpu") is cfg
        with pytest.raises(ValueError, match="fused_nodes_per_step"):
            bt.autotune(cfg, candidates=[(6, 0)], device="cpu")

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_real_probe_matches_jax(self, tmp_path, use_pallas):
        import jax

        import boltzfft as bz

        cfg = _staged(use_pallas=use_pallas)
        tuned = bt.autotune(cfg, k=1, trials=1, cache_file=str(tmp_path / "w.json"),
                            device="cpu")
        assert tuned.node_chunk is not None and tuned.chunk(CPU) <= cfg.n_nodes
        collide, pre = bt.make_collision_operator(tuned, device="cpu")
        f = bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
        got = collide(torch.as_tensor(f), pre).numpy()
        cfg_j = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="rfft")
        want = np.asarray(jax.jit(lambda x, p: bz.collide(cfg_j, p, x))(
            f, bz.build_precomp(cfg_j)))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

    def test_cuda_default_raises_without_a_card(self):
        for fn in (bt.autotune, bt.autotune_ds, bt.autotune_fused):
            assert inspect.signature(fn).parameters["device"].default == "cuda"
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        for fn in (bt.autotune, bt.autotune_ds, bt.autotune_fused):
            with pytest.raises(RuntimeError, match="cuda"):
                fn(_staged())


class TestAutotuneFused:
    def test_returns_cfg_unchanged(self, capsys):
        cfg = _staged(impl="fused")
        assert bt.autotune_fused(cfg, device="cpu") is cfg
        assert capsys.readouterr().out == ""
        assert bt.autotune_fused(cfg, verbose=True, device="cpu") is cfg
        assert "nothing to probe" in capsys.readouterr().out
        staged = _staged()
        assert bt.autotune_fused(staged, device="cpu") is staged

    def test_candidates_raise(self):
        with pytest.raises(ValueError, match="fused_sub_batch"):
            bt.autotune_fused(_staged(impl="fused"), candidates=[(24, 0)], device="cpu")


class TestAutotuneDs:
    def test_picks_fastest_memoizes_and_keeps_wisdom(self, monkeypatch, tmp_path):
        cfg = _staged(n_radial=2)
        calls, pres = [], set()

        def fake_time(c, pre, sb, contract, k, trials, *, device):
            calls.append(sb)
            pres.add(id(pre))
            assert contract == "vpu" and c is cfg
            return {1: 3.0, 2: 1.0, 3: 2.0}[sb]

        monkeypatch.setattr(tune, "_time_ds_candidate", fake_time)
        wisdom = tmp_path / "wisdom.json"
        assert bt.autotune_ds(cfg, cache_file=str(wisdom), device="cpu") == 2
        assert calls == [1, 2, 3] and len(pres) == 1  # the default set capped at ns_eff = 3
        calls.clear()
        assert bt.autotune_ds(cfg, device="cpu") == 2 and calls == []
        tune._MEMO.clear()
        assert bt.autotune_ds(cfg, cache_file=str(wisdom), device="cpu") == 2 and calls == []
        assert "/".join(map(str, tune._ds_key(cfg, "vpu", CPU))) in json.loads(wisdom.read_text())

    def test_oom_skipped_others_raise(self, monkeypatch):
        cfg = _staged(n_radial=2)

        def oom_at_3(c, pre, sb, contract, k, trials, *, device):
            if sb == 3:
                raise _oom()
            return 1.0 / sb

        monkeypatch.setattr(tune, "_time_ds_candidate", oom_at_3)
        assert bt.autotune_ds(cfg, candidates=[1, 2, 3], device="cpu") == 2
        tune._MEMO.clear()

        def broken(c, pre, sb, contract, k, trials, *, device):
            raise RuntimeError("capturing the eval into a CUDA graph failed")

        monkeypatch.setattr(tune, "_time_ds_candidate", broken)
        with pytest.raises(RuntimeError, match="capturing"):
            bt.autotune_ds(cfg, device="cpu")

    def test_all_skipped_gives_the_default(self, monkeypatch):
        def oom(c, pre, sb, contract, k, trials, *, device):
            raise _oom()

        monkeypatch.setattr(tune, "_time_ds_candidate", oom)
        assert bt.autotune_ds(_staged(n_radial=2), device="cpu") == 3  # min(4, ns_eff)

    def test_real_probe(self, tmp_path):
        wisdom = tmp_path / "wisdom.json"
        cfg = bt.CollisionConfig(nv=4, ns=6, n_radial=2, impl="c2c", dtype="float32")
        assert bt.autotune_ds(cfg, candidates=[1, 3], k=1, trials=1, cache_file=str(wisdom),
                              device="cpu") in (1, 3)
        won = tune._MEMO[tune._ds_key(cfg, "vpu", CPU)]
        tune._MEMO.clear()
        assert bt.autotune_ds(cfg, candidates=[2], cache_file=str(wisdom), device="cpu") == won
