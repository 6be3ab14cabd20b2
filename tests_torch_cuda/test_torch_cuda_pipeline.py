"""The pipelined loop's card half (the CPU half:
``tests/test_torch_pipeline.py``): a pending suggest handle's copy to the
host goes through pinned memory and a CUDA event, and a depth-2 ``fmin``
on the card finishes every trial."""

from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import rand, tpe
from hyperopt_tpu_torch.base import JOB_STATE_DONE

SPACE = {"x": ht.hp.uniform("x", -5, 5), "y": ht.hp.normal("y", 0, 2),
         "c": ht.hp.choice("c", [0, 1, 2])}


def _obj(p):
    return (p["x"] - 1.0) ** 2 + p["y"] ** 2 + p["c"]


def _past_startup(n=30):
    trials = ht.Trials()
    ht.fmin(_obj, SPACE, algo=rand.suggest, max_evals=n, trials=trials,
            rstate=np.random.default_rng(0), show_progressbar=False)
    domain = ht.Domain(_obj, SPACE)
    domain.cs.device = "cuda"
    return domain, trials


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
def test_pending_handle_copies_through_pinned_memory(n):
    domain, trials = _past_startup()
    handle = tpe.suggest_dispatch(trials.new_trial_ids(n), domain, trials, 3,
                                  n_EI_candidates=256)
    assert handle[0] == "pending"
    pending = handle[3]
    assert pending.rows.is_cuda and pending.event is None
    assert tpe.suggest_start_transfer(handle) is handle
    assert pending.host.is_pinned() and not pending.host.is_cuda
    pending.event.synchronize()
    assert tpe.suggest_handle_ready(handle)
    plain = pending.rows.cpu().numpy()
    got = pending.fetch()
    assert got.dtype == plain.dtype and got.shape == plain.shape
    np.testing.assert_array_equal(got, plain)
    docs = tpe.suggest_materialize(handle)
    assert [d["tid"] for d in docs] == handle[2]


@pytest.mark.cuda
def test_depth2_fmin_on_the_card_leaves_nothing_running():
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=partial(tpe.suggest, n_EI_candidates=256),
            max_evals=40, max_queue_len=2, trials=t,
            rstate=np.random.default_rng(1), overlap_depth=2, evaluators=2,
            show_progressbar=False)
    assert sorted(d["tid"] for d in t) == list(range(40))
    assert all(d["state"] == JOB_STATE_DONE for d in t)
    assert all(np.isfinite(d["result"]["loss"]) for d in t)
    torch.cuda.synchronize()
