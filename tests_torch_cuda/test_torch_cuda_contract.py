"""``graft_entry_torch.py`` on the card (the CPU half:
``tests/test_torch_driver_contract.py``): the entry step eager and
replayed from a CUDA graph, ``dryrun_multichip(1)`` on a world-1 NCCL
mesh, and the refusal of more ranks than cards."""

import pytest
import torch

import graft_entry_torch as graft
from hyperopt_tpu_torch.ops import ei_scores as ek


@pytest.mark.cuda
def test_entry_step_eager_equals_replayed():
    fn, args = graft.entry()
    ek.reset_launches()
    row, act = fn(*args)
    assert ek.ei_scores.launches_by["f32"] == 1
    assert row.shape == act.shape == (53,) and row.is_cuda
    assert torch.isfinite(row[act]).all()
    ek.reset_launches()
    graph, (g_row, g_act) = graft.capture(fn, args)
    assert ek.ei_scores.recorded_by["f32"] == 1
    for _ in range(3):
        g_row.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_row, row) and torch.equal(g_act, act)


@pytest.mark.cuda
def test_dryrun_multichip_1_on_nccl(capsys):
    graft.dryrun_multichip(1)
    out = capsys.readouterr().out
    assert "nccl on cuda" in out
    assert "mesh={'dp': 1, 'sp': 1}" in out
    assert "trials evaluated" in out
    assert "global mesh OK" in out
    assert not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_dryrun_multichip_refuses_more_ranks_than_cards():
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="cards"):
        graft.dryrun_multichip(n)
