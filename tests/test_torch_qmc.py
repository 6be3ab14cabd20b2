"""``qmc.py`` and TPE's ``startup=`` of the PyTorch port against
hyperopt_tpu.  Both are host numpy and ``scipy.stats.qmc``, so the draws
must be equal, not close (tolerance: none).

* ``qmc.suggest``/``suggest_batch`` equal JAX's for the same seed over
  every distribution family, across successive calls (the sequence
  continues, later seeds are ignored), on resume (a fresh ``Trials`` with
  docs in it fast-forwards), for both engines.
* ``tpe.suggest(startup="qmc")``: the startup trials of a hosted ``fmin``
  equal JAX's, the phase is the Sobol net, a ``startup`` callable and a
  module work, a doc-returning callable is refused.
* ``fmin(mode="device")`` refuses ``startup="qmc"``.
"""

import threading
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import qmc as qmc_j
from hyperopt_tpu_torch import qmc, tpe

CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def every_family(pkg):
    hp = pkg.hp
    return {
        "u": hp.uniform("u", -2.0, 3.0),
        "lu": hp.loguniform("lu", -3.0, 1.0),
        "qu": hp.quniform("qu", 0.0, 10.0, 2.5),
        "qlu": hp.qloguniform("qlu", 0.0, 4.0, 1.0),
        "n": hp.normal("n", 1.0, 2.0),
        "ln": hp.lognormal("ln", 0.0, 0.5),
        "qn": hp.qnormal("qn", 0.0, 3.0, 1.0),
        "qln": hp.qlognormal("qln", 0.0, 1.0, 0.5),
        "ri": hp.randint("ri", 3, 9),
        "ui": hp.uniformint("ui", -2, 4),
        "pc": hp.pchoice("pc", [(0.2, "a"), (0.5, "b"), (0.3, "c")]),
        "br": hp.choice("br", [{"k": 0},
                               {"k": 1, "w": hp.uniform("w", 0.0, 1.0)}]),
    }


def _domains(space_fn=every_family):
    dj = hj.base.Domain(lambda cfg: 0.0, space_fn(hj))
    dt = ht.Domain(lambda cfg: 0.0, space_fn(ht))
    dt.cs.device = CPU
    return dj, dt


def _vals(docs):
    return [(d["tid"], d["misc"]["vals"]) for d in docs]


@pytest.mark.parametrize("engine", ["sobol", "halton"])
def test_suggest_equals_jax_and_continues(engine):
    dj, dt = _domains()
    tj, tt = hj.Trials(), ht.Trials()
    for ids, seed in ((list(range(8)), 5), (list(range(8, 13)), 999)):
        want = qmc_j.suggest(ids, dj, tj, seed, engine=engine)
        got = qmc.suggest(ids, dt, tt, seed, engine=engine)
        assert _vals(got) == _vals(want)
        tj.insert_trial_docs(want)
        tj.refresh()
        tt.insert_trial_docs(got)
        tt.refresh()


def test_suggest_batch_arrays_equal_jax_on_resume():
    """A fresh ``Trials`` holding 6 docs starts a new scramble 6 points
    in, in both packages."""
    dj, dt = _domains()
    first = qmc_j.suggest(list(range(6)), dj, hj.Trials(), 3)
    tt = ht.trials_from_docs(first)
    tj = hj.trials_from_docs(first)
    vj, aj = qmc_j.suggest_batch(list(range(6, 10)), dj, tj, 11)
    vt, at = qmc.suggest_batch(list(range(6, 10)), dt, tt, 11)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(at, aj)
    assert vt.dtype == np.float32 and at.dtype == bool


def test_sobol_16_points_hit_all_16_bins():
    dt = ht.Domain(lambda cfg: 0.0, {"x": ht.hp.uniform("x", 0.0, 16.0)})
    t = ht.Trials()
    docs = qmc.suggest(list(range(16)), dt, t, 0)
    bins = np.floor([d["misc"]["vals"]["x"][0] for d in docs]).astype(int)
    assert sorted(bins.tolist()) == list(range(16))


def test_concurrent_suggests_share_one_sequence():
    dt = ht.Domain(lambda cfg: 0.0, {"x": ht.hp.uniform("x", 0.0, 16.0)})
    t = ht.Trials()
    out, barrier = {}, threading.Barrier(2)

    def go(tag, ids):
        barrier.wait()
        out[tag] = qmc.suggest(ids, dt, t, 0)

    th = [threading.Thread(target=go, args=(k, list(range(8 * k, 8 * k + 8))))
          for k in (0, 1)]
    for x in th:
        x.start()
    for x in th:
        x.join()
    xs = [d["misc"]["vals"]["x"][0] for k in (0, 1) for d in out[k]]
    assert sorted(np.floor(xs).astype(int).tolist()) == list(range(16))


def test_startup_qmc_trials_equal_jax():
    space_j = {"x": hj.hp.uniform("x", -5, 5),
               "c": hj.hp.choice("c", [0, 1, 2])}
    space_t = {"x": ht.hp.uniform("x", -5, 5),
               "c": ht.hp.choice("c", [0, 1, 2])}

    def fn(d):
        return (d["x"] - 1.0) ** 2 + d["c"]

    n_startup = 10
    tj, tt = hj.Trials(), ht.Trials()
    hj.fmin(fn, space_j, algo=partial(hj.tpe.suggest, startup="qmc",
                                      n_startup_jobs=n_startup),
            max_evals=14, trials=tj, rstate=np.random.default_rng(2),
            show_progressbar=False)
    ht.fmin(fn, space_t, algo=partial(tpe.suggest, startup="qmc",
                                      n_startup_jobs=n_startup),
            max_evals=14, trials=tt, rstate=np.random.default_rng(2),
            show_progressbar=False, device=CPU)
    assert len(tt) == 14
    assert _vals(tt._dynamic_trials[:n_startup]) == \
        _vals(tj._dynamic_trials[:n_startup])


def test_startup_phase_is_the_sobol_net():
    t = ht.Trials()
    ht.fmin(lambda cfg: cfg["x"], {"x": ht.hp.uniform("x", 0.0, 16.0)},
            algo=partial(tpe.suggest, startup="sobol", n_startup_jobs=16),
            max_evals=16, trials=t, rstate=np.random.default_rng(0),
            show_progressbar=False, device=CPU)
    xs = [d["misc"]["vals"]["x"][0] for d in t]
    assert sorted(np.floor(xs).astype(int).tolist()) == list(range(16))


def test_startup_callable_module_and_refusal():
    calls = []

    def my_startup(new_ids, domain, trials, seed):
        calls.append(len(new_ids))
        return ht.rand.suggest_batch(new_ids, domain, trials, seed)

    space = {"x": ht.hp.uniform("x", -1, 1)}
    for startup in (my_startup, qmc, "halton", "rand", None):
        t = ht.Trials()
        ht.fmin(lambda cfg: cfg["x"] ** 2, space,
                algo=partial(tpe.suggest, startup=startup, n_startup_jobs=5),
                max_evals=8, trials=t, rstate=np.random.default_rng(0),
                show_progressbar=False, device=CPU)
        assert len(t) == 8
    assert sum(calls) == 5
    with pytest.raises(TypeError, match="startup callable"):
        ht.fmin(lambda cfg: cfg["x"] ** 2, space,
                algo=partial(tpe.suggest, startup=qmc.suggest),
                max_evals=2, trials=ht.Trials(),
                rstate=np.random.default_rng(0), show_progressbar=False,
                device=CPU)


def test_qmc_as_algo_equals_jax():
    space_j = {"x": hj.hp.uniform("x", -5, 5)}
    space_t = {"x": ht.hp.uniform("x", -5, 5)}
    tj, tt = hj.Trials(), ht.Trials()
    hj.fmin(lambda d: d["x"] ** 2, space_j, algo=qmc_j.suggest, max_evals=9,
            trials=tj, rstate=np.random.default_rng(4),
            show_progressbar=False)
    ht.fmin(lambda d: d["x"] ** 2, space_t, algo=qmc.suggest, max_evals=9,
            trials=tt, rstate=np.random.default_rng(4),
            show_progressbar=False, device=CPU)
    assert _vals(tt._dynamic_trials) == _vals(tj._dynamic_trials)
    assert set(qmc.BACKENDS) == set(qmc_j.BACKENDS)


def test_device_mode_refuses_qmc_startup():
    for startup in ("qmc", "halton", qmc):
        with pytest.raises(ValueError, match="host-only"):
            ht.fmin(lambda p: p["x"] * p["x"],
                    {"x": ht.hp.uniform("x", -1, 1)},
                    algo=partial(tpe.suggest, startup=startup),
                    max_evals=4, trials=ht.Trials(),
                    rstate=np.random.default_rng(0), show_progressbar=False,
                    device=CPU, mode="device")
    # "rand" is the captured step's own startup sampler.
    t = ht.Trials()
    ht.fmin(lambda p: p["x"] * p["x"], {"x": ht.hp.uniform("x", -1, 1)},
            algo=partial(tpe.suggest, startup="rand", n_startup_jobs=2),
            max_evals=4, trials=t, rstate=np.random.default_rng(0),
            show_progressbar=False, device=CPU, mode="device")
    assert len(t) == 4


def test_process_pool_draws_in_the_parent():
    """With ``PoolTrials(execution="process")`` the suggest, hence the
    engine, runs in the parent: 16 trials from 16 calls of the algo still
    form the 16-bin net."""
    t = ht.PoolTrials(parallelism=2, execution="process")
    ht.fmin(lambda cfg: cfg["x"], {"x": ht.hp.uniform("x", 0.0, 16.0)},
            algo=qmc.suggest, max_evals=16, trials=t,
            rstate=np.random.default_rng(0), show_progressbar=False,
            device=CPU)
    xs = [d["misc"]["vals"]["x"][0] for d in t]
    assert len(xs) == 16
    assert sorted(np.floor(xs).astype(int).tolist()) == list(range(16))
