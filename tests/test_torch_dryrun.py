"""The port's multi-device dry run (``boltzfft_torch.dryrun``): every family
of the JAX package's ``__graft_entry__.dryrun_multichip`` on 4 and 8 gloo
ranks."""

import pytest
import torch

from boltzfft_torch.dryrun import FAMILIES, dryrun_multichip


@pytest.mark.parametrize("n,mesh", [(4, "{'ensemble': 2, 'node': 2}"),
                                    (8, "{'ensemble': 2, 'node': 4}")])
def test_every_family_on_gloo_ranks(capsys, n, mesh):
    dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    for fam in FAMILIES:
        assert f"dryrun_multichip ok [{fam}]" in out, fam
    assert f"[rfft]: mesh={mesh}" in out and f"[ds]: mesh={mesh}" in out
    cube = "{'cx': 2, 'cy': 2, 'cz': 1}" if n == 4 else "{'cx': 2, 'cy': 2, 'cz': 2}"
    assert f"[spatial3d]: mesh={cube}" in out


def test_families_from_the_environment(capsys, monkeypatch):
    monkeypatch.setenv("BOLTZFFT_DRYRUN_FAMILIES", "rfft,spatial2d")
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "ok [rfft]: mesh={'ensemble': 2, 'node': 1}" in out and "ok [spatial2d]" in out
    assert "ok [ds]" not in out and "ok [fused]" not in out


def test_the_card_needs_its_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"need {have + 1} CUDA cards, have {have}"):
        dryrun_multichip(have + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dryrun_multichip(2, device="meta")
