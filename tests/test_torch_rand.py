"""Random search of the port, against the JAX package.

Case for case the port's run of ``tests/test_rand.py`` with
``device="cpu"``, on the zoo's domains built with the port's ``hp``
(``tests/zoo_torch.py``): the docs' schema and labels equal JAX's docs',
seed determinism, an empty request, and convergence under each zoo
domain's random-search threshold at its budget.  The two packages draw
from different streams (``tests/test_torch_space.py::
test_sampler_matches_jax_distributions`` holds the distributions equal),
so single draws are not compared."""

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import rand
from zoo import ZOO as ZOO_J
from zoo_torch import CONVERGENCE_DOMAINS, ZOO


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _domain(z):
    domain = ht.Domain(z.fn, z.space)
    domain.cs.device = "cpu"
    return domain


def test_suggest_doc_schema():
    domain = _domain(ZOO["many_dists"])
    docs = rand.suggest([0, 1, 2], domain, ht.Trials(), seed=42)
    assert len(docs) == 3
    ht.base.validate_trial_docs(docs)
    z = ZOO_J["many_dists"]
    docs_j = hj.rand.suggest([0, 1, 2], hj.Domain(z.fn, z.space),
                             hj.Trials(), seed=42)
    for doc, doc_j in zip(docs, docs_j):
        assert doc["state"] == ht.JOB_STATE_NEW == doc_j["state"]
        assert set(doc["misc"]["vals"]) == {p.label for p in domain.cs.params}
        assert set(doc["misc"]["vals"]) == set(doc_j["misc"]["vals"])
        assert set(doc) == set(doc_j) and set(doc["misc"]) == \
            set(doc_j["misc"])
        for label, v in doc["misc"]["vals"].items():
            assert doc["misc"]["idxs"][label] == ([doc["tid"]] if v else [])


def test_suggest_seed_determinism():
    domain = _domain(ZOO["branin"])
    trials = ht.Trials()
    d1 = rand.suggest([0], domain, trials, seed=7)
    d2 = rand.suggest([0], domain, trials, seed=7)
    d3 = rand.suggest([0], domain, trials, seed=8)
    assert d1[0]["misc"]["vals"] == d2[0]["misc"]["vals"]
    assert d1[0]["misc"]["vals"] != d3[0]["misc"]["vals"]


def test_empty_new_ids():
    domain = _domain(ZOO["quadratic1"])
    assert rand.suggest([], domain, ht.Trials(), seed=0) == []


@pytest.mark.parametrize("name", CONVERGENCE_DOMAINS)
def test_rand_converges_on_zoo(name):
    z = ZOO[name]
    best = ht.fmin(z.fn, z.space, algo=rand.suggest, max_evals=z.budget,
                   rstate=np.random.default_rng(123), show_progressbar=False,
                   return_argmin=False, device="cpu")
    assert best <= z.rand_thresh, f"{name}: {best} > {z.rand_thresh}"
