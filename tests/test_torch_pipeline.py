"""The port's pipelined loop (``hyperopt_tpu_torch/pipeline.py``,
``fmin(overlap_suggest=, overlap_depth=, evaluators=, max_trial_retries=)``)
against hyperopt_tpu, on the CPU.

* Schedule parity: a test-local dispatch-capable algo whose proposals come
  from ``np.random.default_rng(seed)`` runs through both packages' ``fmin``
  with the same ``rstate`` at depths 1, 2 and 4 and queue lengths 1 and 3,
  one evaluator.  The dispatch logs (ids, seed, finished tids, in-flight
  tids), the trial streams and the ``pipeline_*`` events are equal.
* TPE depth-1 parity: ``overlap_suggest=True`` lands bit for bit the
  trials of the depth-1 overlap loop, replicated inline (the port's copy of
  ``tests/test_pipeline.py::_reference_overlap_stream``).
* TPE with fantasies: a dispatch whose history holds in-flight trials
  proposes JAX's row when handed the uniforms JAX's step draws (the
  ``noise`` route of ``tests/test_torch_liar.py``); rtol 1e-5, atol 1e-6,
  integer columns exact.
* Behaviour, mirroring ``tests/test_pipeline.py`` and the pipeline cases
  of ``tests/test_faults.py``: determinism, unique tids under four
  evaluators, occupancy and stall metrics, the timeout, early-stop and
  objective-exception drains, the scan cursor, the degradation of an algo
  without dispatch, slot failures, the fallback after three, transient
  retries.
* Cohorts: ``CohortScheduler.algo()`` at depth 2 lands solo
  ``tpe.suggest``'s trials at depth 2, bit for bit.

Waits are on counts and events, never on sleeps that race.
"""

import time
from functools import partial

import jax
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.obs.events import EVENTS as EVENTS_J
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import faults, fleet, rand, tpe
from hyperopt_tpu_torch.exceptions import InjectedFault
from hyperopt_tpu_torch.base import (
    Ctrl,
    Domain,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    spec_from_misc,
)
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.obs.events import EVENTS as EVENTS_T
from hyperopt_tpu_torch.obs.metrics import registry
from test_torch_tpe import _jax_step_uniforms, flagship


def _space(pkg):
    return {"x": pkg.hp.uniform("x", -5, 5), "y": pkg.hp.normal("y", 0, 2)}


SPACE = _space(ht)
ALGO_KW = dict(n_startup_jobs=4, n_EI_candidates=32)
TPE = partial(tpe.suggest, **ALGO_KW)
RUN = dict(show_progressbar=False, device="cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    yield
    faults.clear()


def _obj(p):
    return (p["x"] - 1.0) ** 2 + p["y"] ** 2


def _counter(name):
    return registry().snapshot()["counters"].get(name, 0.0)


def _stream(t):
    """(tid, vals, loss) in storage order."""
    return [(d["tid"],
             {k: tuple(v) for k, v in d["misc"]["vals"].items()},
             d["result"].get("loss"))
            for d in t.trials]


def _states(t):
    return [d["state"] for d in t]


# -- schedule parity with the JAX package --------------------------------------


def recording_algo(pkg, log):
    """A dispatch-capable algo for package ``pkg``: proposals from
    ``np.random.default_rng(seed)``; each dispatch appends ``(ids, seed,
    finished tids, in-flight tids)`` to ``log``."""

    def dispatch(new_ids, domain, trials, seed):
        dyn = trials._dynamic_trials
        log.append((list(new_ids), int(seed),
                    sorted(d["tid"] for d in dyn
                           if d["state"] in (JOB_STATE_DONE,
                                             JOB_STATE_ERROR)),
                    sorted(d["tid"] for d in dyn
                           if d["state"] in (JOB_STATE_NEW,
                                             JOB_STATE_RUNNING))))
        rng = np.random.default_rng(seed)
        docs = []
        for tid in new_ids:
            doc = pkg.base.new_trial_doc(tid, exp_key=trials.exp_key)
            doc["misc"]["idxs"] = {"x": [tid], "y": [tid]}
            doc["misc"]["vals"] = {"x": [float(rng.uniform(-5, 5))],
                                   "y": [float(rng.normal(0, 2))]}
            docs.append(doc)
        return docs

    def suggest(new_ids, domain, trials, seed):
        return dispatch(new_ids, domain, trials, seed)

    suggest.dispatch = dispatch
    suggest.materialize = lambda handle: handle
    return suggest


def _pipeline_events(events):
    return [(e["type"], e.get("n"), e.get("slot"), e.get("depth"),
             e.get("reason"))
            for e in events if e["type"].startswith("pipeline_")]


def _recorded_run(pkg, events, **kw):
    log = []
    t = pkg.Trials()
    events.clear()
    events.enable()
    try:
        extra = {"device": "cpu"} if pkg is ht else {}
        pkg.fmin(_obj, _space(pkg), algo=recording_algo(pkg, log),
                 trials=t, rstate=np.random.default_rng(11),
                 show_progressbar=False, **extra, **kw)
        evs = _pipeline_events(events.snapshot())
    finally:
        events.disable()
        events.clear()
    return log, _stream(t), evs


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("queue", [1, 3])
def test_schedule_matches_jax(depth, queue):
    kw = dict(max_evals=13, overlap_depth=depth, max_queue_len=queue,
              evaluators=1)
    log_j, stream_j, ev_j = _recorded_run(hj, EVENTS_J, **kw)
    log_t, stream_t, ev_t = _recorded_run(ht, EVENTS_T, **kw)
    assert log_t == log_j
    assert stream_t == stream_j
    assert ev_t == ev_j
    assert sorted(s[0] for s in stream_t) == list(range(13))
    # Dispatches overlap evaluation: some see trials in flight.
    assert any(entry[3] for entry in log_t)


def test_pool_schedule_matches_jax():
    """An asynchronous ``PoolTrials`` (one thread) polls the same
    schedule in both packages."""
    runs = []
    for pkg in (hj, ht):
        log = []
        t = pkg.PoolTrials(parallelism=1)
        extra = {"device": "cpu"} if pkg is ht else {}
        pkg.fmin(_obj, _space(pkg), algo=recording_algo(pkg, log),
                 max_evals=6, trials=t, rstate=np.random.default_rng(4),
                 show_progressbar=False, **extra)
        runs.append((log, _stream(t)))
    assert runs[1] == runs[0]
    assert [entry[0] for entry in runs[1][0]] == [[i] for i in range(6)]


# -- TPE through the pipeline -------------------------------------------------


def _reference_overlap_stream(seed, max_evals, queue):
    """The depth-1 overlap loop, inline: materialize the pending batch
    (clamped), insert it, dispatch the next batch on the just-inserted NEW
    trials, then evaluate serially; one ``integers(2**31-1)`` draw per
    dispatched batch, drawn before ``new_trial_ids``."""
    domain = Domain(_obj, SPACE)
    domain.cs.device = "cpu"
    trials = ht.Trials()
    rstate = np.random.default_rng(seed)
    dispatch = tpe.suggest.dispatch
    materialize = tpe.suggest.materialize
    pending = None

    def n_done():
        return sum(d["state"] in (JOB_STATE_DONE, JOB_STATE_ERROR)
                   for d in trials._dynamic_trials)

    while n_done() < max_evals:
        remaining = max_evals - len(trials._dynamic_trials)
        n_to_enqueue = min(queue, remaining)
        if pending is not None:
            docs = materialize(pending)[:n_to_enqueue]
            pending = None
        else:
            s = int(rstate.integers(2 ** 31 - 1))
            ids = trials.new_trial_ids(n_to_enqueue)
            trials.refresh()
            docs = tpe.suggest(ids, domain, trials, s, **ALGO_KW)
        if not docs:
            break
        trials.insert_trial_docs(docs)
        trials.refresh()
        if remaining > n_to_enqueue:
            s = int(rstate.integers(2 ** 31 - 1))
            ids = trials.new_trial_ids(min(queue, remaining - n_to_enqueue))
            pending = dispatch(ids, domain, trials, s, **ALGO_KW)
        for doc in trials._dynamic_trials:
            if doc["state"] == JOB_STATE_NEW:
                doc["state"] = JOB_STATE_RUNNING
                doc["result"] = domain.evaluate(
                    spec_from_misc(doc["misc"]),
                    Ctrl(trials, current_trial=doc))
                doc["state"] = JOB_STATE_DONE
        trials.refresh()
    return trials


@pytest.mark.parametrize("queue,max_evals", [(1, 18), (4, 19)])
def test_depth1_bit_identical_to_the_overlap_loop(queue, max_evals):
    ref = _reference_overlap_stream(42, max_evals, queue)
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=TPE, max_evals=max_evals, max_queue_len=queue,
            trials=t, rstate=np.random.default_rng(42), overlap_suggest=True,
            **RUN)
    assert _stream(t) == _stream(ref)


def test_depth1_argument_is_the_overlap_alias():
    a, b = ht.Trials(), ht.Trials()
    kw = dict(algo=TPE, max_evals=14, **RUN)
    ht.fmin(_obj, SPACE, trials=a, rstate=np.random.default_rng(3),
            overlap_suggest=True, **kw)
    ht.fmin(_obj, SPACE, trials=b, rstate=np.random.default_rng(3),
            overlap_depth=1, **kw)
    assert _stream(a) == _stream(b)


def _flagship_trials(pkg, n_done, n_inflight, seed):
    """``n_done`` finished and ``n_inflight`` RUNNING trials of the flagship
    space, the same docs in either package."""
    cs = hj.space.compile_space(flagship(hj))
    vals = np.asarray(cs.sample(jax.random.key(seed), n_done + n_inflight)[0])
    active = cs.active_mask_host(vals)
    rng = np.random.default_rng(seed)
    loss = (np.square(vals[:, :4]).sum(1)
            + rng.normal(0, 0.1, len(vals))).astype(np.float32)
    cs_p = (pkg.space.compile_space(flagship(pkg)))
    docs = pkg.base.docs_from_samples(cs_p, list(range(len(vals))), vals,
                                      active)
    for i, d in enumerate(docs):
        if i < n_done:
            d["state"] = JOB_STATE_DONE
            d["result"] = {"loss": float(loss[i]), "status": "ok"}
        else:
            d["state"] = JOB_STATE_RUNNING
    return pkg.trials_from_docs(docs)


@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_with_inflight_trials_proposes_jax_rows(monkeypatch, seed):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    n_done, n_inflight, n_cand = 40, 3, 128
    tj = _flagship_trials(hj, n_done, n_inflight, seed)
    tt = _flagship_trials(ht, n_done, n_inflight, seed)
    dj = hj.base.Domain(lambda d: 0.0, flagship(hj))
    dt = Domain(lambda d: 0.0, flagship(ht))
    dt.cs.device = "cpu"
    ids = [n_done + n_inflight]
    want = hj.tpe.suggest_materialize(tpe_j.suggest_dispatch(
        ids, dj, tj, 77 + seed, n_EI_candidates=n_cand))
    # The port's step takes JAX's uniforms for the same seed.
    kj = tpe_j.get_kernel(dj.cs, 64, n_cand, 25)
    noise = _jax_step_uniforms(prng_key(np.uint32(77 + seed)), kj)
    monkeypatch.setattr(tpe._TpeKernel, "draw_noise",
                        lambda self, generator=None: noise)
    c0 = ht.history.upload_bytes
    handle = tpe.suggest_dispatch(ids, dt, tt, 77 + seed,
                                  n_EI_candidates=n_cand)
    assert tpe.suggest_start_transfer(handle) is handle
    assert tpe.suggest_handle_ready(handle)
    got = tpe.suggest_materialize(handle)
    p = dt.cs.n_params
    # The three in-flight rows were overlaid on the device copy.
    assert ht.history.upload_bytes - c0 >= n_inflight * (4 * p + p)
    (gv,), (wv,) = [d["misc"]["vals"] for d in got], \
        [d["misc"]["vals"] for d in want]
    assert set(gv) == set(wv)
    ints = {q.label for q in dt.cs.params if q.is_int}
    for k in wv:
        if k in ints:
            assert gv[k] == wv[k], k
        else:
            np.testing.assert_allclose(gv[k], wv[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_cohorts_at_depth2_equal_solo_tpe_at_depth2():
    runs = []
    for algo in (TPE, partial(fleet.CohortScheduler().algo(), **ALGO_KW)):
        t = ht.Trials()
        ht.fmin(_obj, SPACE, algo=algo, max_evals=16, max_queue_len=2,
                trials=t, rstate=np.random.default_rng(6), overlap_depth=2,
                **RUN)
        runs.append(_stream(t))
    assert runs[0] == runs[1]
    assert len(runs[0]) == 16


def test_cohort_handles_carry_the_transfer_halves():
    """A real cohort of two experiments: the transfer halves run on the
    shared result and the rows are each experiment's solo rows."""
    reqs = []
    for i in range(2):
        t = ht.Trials()
        ht.fmin(_obj, SPACE, algo=rand.suggest, max_evals=24, trials=t,
                rstate=np.random.default_rng(30 + i), **RUN)
        d = Domain(_obj, SPACE)
        d.cs.device = "cpu"
        reqs.append((t.new_trial_ids(1), d, t, 5 + i))
    want = [[doc["misc"]["vals"] for doc in tpe.suggest(*r)] for r in reqs]
    hd = fleet.CohortScheduler().suggest_dispatch(reqs)
    assert [h[0] for h in hd] == ["fleet", "fleet"]
    for h in hd:
        assert fleet.suggest_start_transfer(h) is h
        assert fleet.suggest_handle_ready(h)
    got = [[doc["misc"]["vals"] for doc in fleet.suggest_materialize(h)]
           for h in hd]
    assert got == want


def test_cohort_algo_carries_the_four_halves():
    algo = fleet.CohortScheduler().algo()
    for half in ("dispatch", "materialize", "start_transfer", "handle_ready"):
        assert callable(getattr(algo, half))
    for half in ("dispatch", "materialize", "start_transfer", "handle_ready"):
        assert callable(getattr(tpe.suggest, half))


# -- behaviour ------------------------------------------------------------------


def test_depth_d_is_deterministic_given_the_seed():
    runs = []
    for _ in range(2):
        t = ht.Trials()
        ht.fmin(_obj, SPACE, algo=TPE, max_evals=24, max_queue_len=2,
                trials=t, rstate=np.random.default_rng(9), overlap_depth=3,
                **RUN)
        runs.append(_stream(t))
    assert runs[0] == runs[1]
    assert len(runs[0]) == 24


def test_no_duplicate_tids_with_four_evaluators():
    def bumpy(p):
        # Per-trial jitter, so that evaluators finish out of order.
        time.sleep(0.001 + (abs(p["x"]) % 0.01))
        return _obj(p)

    t = ht.Trials()
    ht.fmin(bumpy, SPACE, algo=TPE, max_evals=30, max_queue_len=2,
            trials=t, rstate=np.random.default_rng(5), overlap_depth=4,
            evaluators=4, **RUN)
    assert sorted(d["tid"] for d in t) == list(range(30))
    assert all(s == JOB_STATE_DONE for s in _states(t))


def test_occupancy_and_stall_metrics():
    s0 = _counter("pipeline.stall.suggest_bound") + \
        _counter("pipeline.stall.eval_bound")
    t = ht.Trials()
    ht.fmin(lambda p: (time.sleep(0.002), _obj(p))[1], SPACE, algo=TPE,
            max_evals=16, max_queue_len=2, trials=t,
            rstate=np.random.default_rng(2), overlap_depth=4, **RUN)
    snap = registry().snapshot()
    assert snap["gauges"]["pipeline.occupancy"] == 0.0      # drained
    assert snap["gauges"]["pipeline.eval_backlog"] == 0.0
    assert snap["histograms"]["pipeline.occupancy"]["count"] > 0
    hs = snap["histograms"]["suggest.dispatch_ms"]
    assert hs["count"] > 0 and hs["p95"] >= hs["p50"] > 0
    # On the CPU every handle is ready at once: the evaluator is the bound.
    assert _counter("pipeline.stall.eval_bound") + \
        _counter("pipeline.stall.suggest_bound") > s0


def test_timeout_drains_without_orphans():
    def slow(p):
        time.sleep(0.1)
        return _obj(p)

    t = ht.Trials()
    ht.fmin(slow, SPACE, algo=TPE, max_evals=200, max_queue_len=2,
            trials=t, rstate=np.random.default_rng(0), overlap_depth=4,
            evaluators=2, timeout=0.8, **RUN)
    assert JOB_STATE_RUNNING not in _states(t)
    assert JOB_STATE_NEW not in _states(t)
    assert len(t) < 200
    for d in t:
        if d["state"] == JOB_STATE_ERROR:
            assert d["misc"]["error"][0] == "Cancelled"


def test_early_stop_discards_the_ring():
    """The handles still in the ring are dropped (their tids never
    inserted); a trial queued but not yet started when the stop fires is
    cancelled, one already started finishes: which of the two a queued
    trial is depends on the evaluator thread, so both are allowed."""
    t = ht.Trials()
    EVENTS_T.clear()
    EVENTS_T.enable()
    try:
        ht.fmin(_obj, SPACE, algo=TPE, max_evals=100, trials=t,
                rstate=np.random.default_rng(7), overlap_depth=4,
                early_stop_fn=ht.no_progress_loss(5), **RUN)
        cancels = [e for e in EVENTS_T.snapshot()
                   if e["type"] == "pipeline_cancel"]
    finally:
        EVENTS_T.disable()
        EVENTS_T.clear()
    assert 0 < len(t) < 100
    assert cancels and {e["reason"] for e in cancels} == {"early stop"}
    assert sorted(d["tid"] for d in t) == list(range(len(t)))
    for d in t:
        assert d["state"] == JOB_STATE_DONE or (
            d["state"] == JOB_STATE_ERROR
            and d["misc"]["error"] == ("Cancelled", "early stop"))
    assert JOB_STATE_DONE in _states(t)


def test_objective_exception_propagates_and_drains():
    def boom(p):
        raise RuntimeError("boom")

    t = ht.Trials()
    with pytest.raises(RuntimeError, match="boom"):
        ht.fmin(boom, SPACE, algo=TPE, max_evals=10, trials=t,
                rstate=np.random.default_rng(1), overlap_depth=2, **RUN)
    assert JOB_STATE_RUNNING not in _states(t)


def test_scan_cursor_skips_the_settled_prefix():
    """Ten one-trial batches: the cursor skips the finished prefix each
    pass (0 + 1 + ... + 9), and the closing sweep skips all ten."""
    c0 = _counter("fmin.scan_skipped")
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=rand.suggest, max_evals=10, trials=t,
            rstate=np.random.default_rng(0), **RUN)
    assert len(t) == 10
    assert _counter("fmin.scan_skipped") - c0 == sum(range(10)) + 10


def test_depth_defaults_and_non_dispatch_algos():
    d = Domain(_obj, SPACE)
    d.cs.device = "cpu"
    it = FMinIter(tpe.suggest, d, ht.Trials(), show_progressbar=False)
    assert it.overlap_depth == 0 and it._pipeline is None
    it = FMinIter(tpe.suggest, d, ht.Trials(), evaluators=3,
                  show_progressbar=False)
    assert it.overlap_depth == 1 and it._pipeline.evaluators == 3
    it = FMinIter(rand.suggest, d, ht.Trials(), overlap_depth=4,
                  show_progressbar=False)
    assert it._pipeline is None and not it.overlap_suggest
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=rand.suggest, max_evals=8, trials=t,
            rstate=np.random.default_rng(4), overlap_depth=4, evaluators=2,
            **RUN)
    assert len(t) == 8 and all(s == JOB_STATE_DONE for s in _states(t))


def test_device_mode_refuses_the_pipeline_arguments():
    for kw in (dict(overlap_depth=2), dict(evaluators=2),
               dict(overlap_suggest=True), dict(max_trial_retries=1)):
        with pytest.raises(ValueError, match=next(iter(kw))):
            ht.fmin(lambda p: p["x"], {"x": ht.hp.uniform("x", 0, 1)},
                    max_evals=4, mode="device", **RUN, **kw)
    with pytest.raises(ValueError, match="asynchronous"):
        ht.fmin(lambda p: p["x"], {"x": ht.hp.uniform("x", 0, 1)},
                max_evals=4, mode="device", trials=ht.PoolTrials(), **RUN)


# -- recovery (tests/test_faults.py) -------------------------------------------


def test_dispatch_faults_are_absorbed():
    """Two failed dispatches, then the run completes with gapless tids (the
    id allocation rolls back on failure)."""
    faults.configure({"pipeline.dispatch": {"prob": 1.0, "times": 2}},
                     seed=7)
    sf0, fb0 = _counter("pipeline.slot.failed"), _counter("pipeline.fallbacks")
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=TPE, max_evals=6, trials=t,
            rstate=np.random.default_rng(0), overlap_depth=2, **RUN)
    faults.clear()
    assert sorted(d["tid"] for d in t) == list(range(6))
    assert _states(t) == [JOB_STATE_DONE] * 6
    assert _counter("pipeline.slot.failed") == sf0 + 2
    assert _counter("pipeline.fallbacks") == fb0


def test_transient_objective_is_resubmitted():
    faults.configure({"objective.call": {"prob": 0.4, "times": 4}}, seed=7)
    r0 = _counter("fmin.trials.retried")
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=TPE, max_evals=8, trials=t,
            rstate=np.random.default_rng(0), overlap_depth=2,
            max_trial_retries=6, **RUN)
    faults.clear()
    assert _states(t) == [JOB_STATE_DONE] * 8
    n_retries = sum(d["misc"].get("fail_count", 0) for d in t)
    assert n_retries >= 1
    assert _counter("fmin.trials.retried") - r0 == n_retries


def test_total_dispatch_failure_falls_back_to_the_sync_loop():
    fb0 = _counter("pipeline.fallbacks")
    faults.configure({"pipeline.dispatch": 1.0}, seed=1)
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=TPE, max_evals=5, trials=t,
            rstate=np.random.default_rng(0), overlap_depth=2, **RUN)
    faults.clear()
    assert _states(t) == [JOB_STATE_DONE] * 5
    assert _counter("pipeline.fallbacks") == fb0 + 1


def test_a_transfer_that_cannot_start_fails_its_slot(monkeypatch):
    """No blocking fetch stands in for a copy that did not start: the slot
    fails, is dispatched again, and after three the sync loop runs."""
    def broken(handle):
        raise RuntimeError("no pinned memory")

    monkeypatch.setattr(tpe.suggest, "start_transfer", broken)
    sf0, fb0 = _counter("pipeline.slot.failed"), _counter("pipeline.fallbacks")
    t = ht.Trials()
    ht.fmin(_obj, SPACE, algo=TPE, max_evals=7, trials=t,
            rstate=np.random.default_rng(0), overlap_depth=2, **RUN)
    assert _states(t) == [JOB_STATE_DONE] * 7
    assert _counter("pipeline.fallbacks") == fb0 + 1
    assert _counter("pipeline.slot.failed") == sf0 + 3


@pytest.mark.parametrize("retries,fails", [(3, 2), (1, 2)])
def test_serial_loop_retries_transient_faults(retries, fails):
    faults.configure({"objective.call": {"prob": 1.0, "times": fails}},
                     seed=1)
    t = ht.Trials()
    if retries < fails:
        with pytest.raises(InjectedFault):
            ht.fmin(_obj, SPACE, algo=rand.suggest, max_evals=5, trials=t,
                    rstate=np.random.default_rng(0), max_trial_retries=retries,
                    **RUN)
        return
    ht.fmin(_obj, SPACE, algo=rand.suggest, max_evals=5, trials=t,
            rstate=np.random.default_rng(0), max_trial_retries=retries,
            **RUN)
    assert _states(t) == [JOB_STATE_DONE] * 5
    assert t._dynamic_trials[0]["misc"]["fail_count"] == fails
