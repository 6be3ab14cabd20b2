"""The other suggest heads on the card (their CPU half:
``tests/test_torch_backends.py``, ``test_torch_anneal.py``,
``test_torch_atpe.py``, ``test_torch_gp_es.py``): every unique head passes
the conformance suite on CUDA, the GP and ES dispatches and their copies
to the host do not synchronize, and the card's rows equal the CPU's on
the same draws."""

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import anneal, atpe, tpe
from hyperopt_tpu_torch.backends import contract, es, gp, resolve

UNIQUE_HEADS = ["rand", "tpe", "tpe_quantile", "tpe_sobol", "tpe_mv",
                "qmc", "halton", "anneal", "atpe", "gp", "es"]


@pytest.fixture(autouse=True)
def _no_transfer_memory():
    old = atpe.set_transfer_store(None)
    yield
    atpe.set_transfer_store(old)


@pytest.mark.cuda
@pytest.mark.parametrize("name", UNIQUE_HEADS)
def test_conformance_on_the_card(name):
    out = contract.run_conformance(resolve(name), device="cuda")
    assert set(out) == set(contract.CONFORMANCE_CHECKS)


def _seeded(device, n=40):
    domain = contract.conformance_domain(device)
    return domain, contract.seeded_trials(domain, n=n, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [gp, es])
@pytest.mark.parametrize("n", [1, 8])
def test_dispatch_is_free_of_syncs(head, n):
    domain, trials = _seeded("cuda")
    ids = list(range(40, 40 + n))
    head.suggest(ids, domain, trials, 1)          # warm program and ring
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = head.suggest.dispatch(ids, domain, trials, 2)
        head.suggest.start_transfer(handle)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert handle[0] == "pending" and handle[3].host.is_pinned()
    docs = head.suggest.materialize(handle)
    assert [d["tid"] for d in docs] == ids


@pytest.mark.cuda
def test_card_rows_equal_cpu_rows_on_the_same_draws():
    """GP (one proposal: a liar step's EI can underflow to 0 on a confident
    fit, and then the pick is a tie; ``chip_smoke.py`` compares the steps
    up to there), ES and anneal on one history and the same draws, the
    space's device switched between the calls: categorical values equal,
    continuous ones within 1e-5."""
    dom, trials = _seeded("cuda")
    cand = [dom.cs.sample(32, generator=torch.Generator().manual_seed(i),
                          device="cpu") for i in range(4)]
    noise = torch.randn((4, dom.cs.n_params),
                        generator=torch.Generator().manual_seed(5))
    kern = anneal._get_kernel(dom.cs, torch.device("cpu"))
    a_noise = kern.draw_noise(8, torch.Generator().manual_seed(6))
    calls = [
        lambda: gp.suggest([40], dom, trials, 3, n_EI_candidates=32,
                           cand=cand[:1]),
        lambda: es.suggest(list(range(40, 48)), dom, trials, 3, noise=noise),
        lambda: anneal.suggest(list(range(40, 48)), dom, trials, 3,
                               noise=a_noise)]
    for call in calls:
        dom.cs.device = "cpu"
        want = call()
        dom.cs.device = "cuda"
        got = call()
        assert [d["misc"]["vals"]["c"] for d in got] == \
            [d["misc"]["vals"]["c"] for d in want]
        np.testing.assert_allclose(
            [d["misc"]["vals"]["x"] for d in got],
            [d["misc"]["vals"]["x"] for d in want], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_atpe_tpe_arm_runs_the_ei_kernel():
    from hyperopt_tpu_torch.ops import ei_scores

    domain, trials = _seeded("cuda", n=30)
    ei_scores.reset_launches()
    atpe.suggest([30], domain, trials, 4)
    tpe.wait_prewarm()
    arm = trials._atpe_state.pending[30][0]
    assert ei_scores.ei_scores.launches == 1, arm
