"""End-to-end quality of the port's other heads against the JAX package.

GP (``algo="gp"``), ES (``"es"``), ATPE (``"atpe"``) and ``mix`` (half
random search, half TPE) each run ``fmin`` on three zoo domains
(``quadratic1``, ``n_arms``, ``q1_lognormal``; the port's spaces from
``tests/zoo_torch.py``) at seeds 0-2 and a budget of
``min(z.budget, 40)``, in both packages.  The criterion is
``tests/test_torch_tpe.py::test_fmin_quality_parity``'s: the port's
median best loss within half the distance between the zoo's TPE
threshold and the optimum of the JAX median, and both medians at or under
the threshold (JAX's median meets it on every pair here).  The packages
draw from different streams, so runs are compared as distributions of
three.  ATPE's transfer memory is off in both."""

from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import atpe
from zoo import ZOO as ZOO_J
from zoo_torch import ZOO as ZOO_T

DOMAINS = ("quadratic1", "n_arms", "q1_lognormal")
HEADS = ("gp", "es", "atpe", "mix")
SEEDS = range(3)


def _algo(pkg, head):
    if head == "mix":
        return partial(pkg.mix.suggest,
                       p_suggest=[(0.5, pkg.rand.suggest),
                                  (0.5, pkg.tpe.suggest)])
    return head


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("HYPEROPT_TPU_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("HYPEROPT_TPU_ATPE_TRANSFER", "0")
    old = atpe.set_transfer_store(None)
    yield
    atpe.set_transfer_store(old)
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", DOMAINS)
@pytest.mark.parametrize("head", HEADS)
def test_head_quality_parity(head, name):
    zj, zt = ZOO_J[name], ZOO_T[name]
    budget = min(zj.budget, 40)
    best_j, best_t = [], []
    for seed in SEEDS:
        tj, tt = hj.Trials(), ht.Trials()
        hj.fmin(zj.fn, zj.space, algo=_algo(hj, head), max_evals=budget,
                trials=tj, rstate=np.random.default_rng(seed),
                show_progressbar=False)
        ht.fmin(zt.fn, zt.space, algo=_algo(ht, head), max_evals=budget,
                trials=tt, rstate=np.random.default_rng(seed),
                show_progressbar=False, device="cpu")
        assert len(tt) == budget
        best_j.append(tj.best_trial["result"]["loss"])
        best_t.append(tt.best_trial["result"]["loss"])
    tol = 0.5 * abs(zj.tpe_thresh - zj.best_loss)
    mj, mt = np.median(best_j), np.median(best_t)
    assert mt <= zj.tpe_thresh and mj <= zj.tpe_thresh, (best_t, best_j)
    assert abs(mt - mj) <= tol, (best_t, best_j)
