"""Long-horizon TPE/ATPE runs of the PyTorch port, case for case with
``tests/test_tpe_longrun.py``, on the CPU.

* a 1,050-trial run crosses the 32 → 1,024 history buckets with one
  kernel per bucket, and still improves late in the run;
* a 320-trial run at ``max_queue_len=8`` runs every liar batch at ``m =
  8`` (the JAX test reads its jit cache of batch programs; the port's
  counterpart is the batch size ``tpe._batch_size_for`` gives each
  batch);
* TPE beats random search on the rest of the convergence zoo, and ATPE
  meets TPE's bar.

The JAX file marks them slow; on the port each takes seconds, so they run
in the quick tier.  The two ladders live in ``tests/torch_ladders.py``,
which the card's file (``tests_torch_cuda/test_torch_cuda_tpe_longrun.py``)
runs too.
"""

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import Trials, atpe, fmin, rand, tpe
from torch_ladders import batched_bucket_ladder, thousand_trials_bucket_ladder
from zoo_torch import CONVERGENCE_DOMAINS, ZOO

CPU = "cpu"
SEEDS = [0, 1, 2]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(domain_name, algo, seed, max_evals=None):
    z = ZOO[domain_name]
    t = Trials()
    fmin(z.fn, z.space, algo=algo, max_evals=max_evals or z.budget,
         trials=t, rstate=np.random.default_rng(seed),
         show_progressbar=False, device=CPU)
    return t


class TestLongRun:
    def test_thousand_trials_bucket_ladder(self):
        thousand_trials_bucket_ladder(CPU)

    def test_batched_bucket_ladder(self, monkeypatch):
        batched_bucket_ladder(CPU, monkeypatch)


class TestConvergenceFull:
    """TPE beats random search on the whole convergence zoo."""

    @pytest.mark.parametrize(
        "name", [n for n in CONVERGENCE_DOMAINS
                 if n not in ("quadratic1", "branin", "q1_choice", "n_arms")])
    def test_tpe_beats_random_extended(self, name):
        z = ZOO[name]
        tpe_best = np.median([
            _run(name, tpe.suggest, s).best_trial["result"]["loss"]
            for s in SEEDS])
        rand_best = np.median([
            _run(name, rand.suggest, s).best_trial["result"]["loss"]
            for s in SEEDS])
        assert tpe_best <= rand_best + 0.05 * abs(rand_best) + 1e-12, \
            (tpe_best, rand_best)
        assert tpe_best <= z.tpe_thresh, (tpe_best, z.tpe_thresh)

    def test_atpe_matches_tpe_bar(self):
        old = atpe.set_transfer_store(None)
        try:
            self._atpe_bar()
        finally:
            atpe.set_transfer_store(old)

    def _atpe_bar(self):
        for name in ("quadratic1", "q1_choice"):
            z = ZOO[name]
            best = np.median([
                _run(name, atpe.suggest, s).best_trial["result"]["loss"]
                for s in SEEDS])
            assert best <= z.tpe_thresh * 1.5 + 1e-12, (name, best)
