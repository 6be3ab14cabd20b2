"""The port's ``PoolTrials`` and ``CompletionQueueEvaluator``
(``hyperopt_tpu_torch/parallel/pool.py``) on the CPU, mirroring
``tests/test_pool.py`` (``TestPoolTrials``, ``TestCancellation``,
``TestFMinIterProtocol``) and the pool cases of ``tests/test_faults.py``:
parallel evaluation and its cap, trial timeouts, exception isolation, TPE
through the pool, process-mode kills at the deadline and on ``fmin``'s
timeout, attachments from a forked child, cooperative cancellation of
threads, re-forking a child that died on a transient error, an exhausted
retry budget, the SIGTERM→SIGKILL escalation, and the evaluator's queue
drain.  One test runs the same pool schedule through both packages.

Waits are on events with timeouts, never on sleeps that race.
"""

import multiprocessing
import signal
import threading
import time

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import faults, rand, tpe
from hyperopt_tpu_torch.base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    Domain,
)
from hyperopt_tpu_torch.exceptions import (
    AllTrialsFailed,
    TransientEvaluationError,
)
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.parallel import CompletionQueueEvaluator, PoolTrials

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


def _space(pkg=ht):
    return {"x": pkg.hp.uniform("x", -5, 5)}


def _counter(name):
    return registry().snapshot()["counters"].get(name, 0.0)


def _fmin(fn, trials, max_evals, algo=rand.suggest, seed=0, **kw):
    return ht.fmin(fn, _space(), algo=algo, max_evals=max_evals,
                   trials=trials, rstate=np.random.default_rng(seed), **RUN,
                   **kw)


class TestPoolTrials:
    def test_parallel_evaluation(self):
        seen = set()
        lock = threading.Lock()

        def fn(d):
            with lock:
                seen.add(threading.current_thread().name)
            time.sleep(0.01)
            return (d["x"] - 3.0) ** 2

        t = PoolTrials(parallelism=4)
        best = _fmin(fn, t, 20)
        assert len(t) == 20
        assert all(d["state"] == JOB_STATE_DONE for d in t)
        assert "x" in best
        assert len(seen) > 1

    def test_parallelism_cap(self):
        active, peak = [], []
        lock = threading.Lock()

        def fn(d):
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.03)
            with lock:
                active.pop()
            return d["x"] ** 2

        _fmin(fn, PoolTrials(parallelism=2), 10)
        assert max(peak) <= 2

    def test_trial_timeout_marks_error(self):
        def fn(d):
            time.sleep(0.2)
            return d["x"] ** 2

        t = PoolTrials(parallelism=2, trial_timeout=0.05)
        with pytest.raises(AllTrialsFailed):
            _fmin(fn, t, 4)
        assert all(d["state"] == JOB_STATE_ERROR for d in t)

    def test_exception_isolation(self):
        def fn(d):
            if d["x"] < 0:
                raise RuntimeError("negative")
            return d["x"] ** 2

        t = PoolTrials(parallelism=3)
        _fmin(fn, t, 16, seed=3)
        states = {d["state"] for d in t}
        assert JOB_STATE_DONE in states and JOB_STATE_ERROR in states
        assert t.best_trial["result"]["loss"] >= 0

    def test_tpe_through_pool(self):
        t = PoolTrials(parallelism=4)
        _fmin(lambda d: (d["x"] - 3.0) ** 2, t, 40, algo=tpe.suggest)
        assert len(t) == 40
        assert t.best_trial["result"]["loss"] < 1.0

    def test_pool_is_asynchronous_and_delegates(self):
        assert PoolTrials.asynchronous and not ht.Trials.asynchronous
        t = PoolTrials(parallelism=2)
        _fmin(lambda d: d["x"] ** 2, t, 4)
        assert t._domain is not None and t._pool is None     # shut down

    def test_same_results_as_jax_on_one_thread(self):
        """A deterministic algo through ``PoolTrials(parallelism=1)`` of
        both packages lands the same trials."""
        runs = []
        for pkg in (hj, ht):
            def algo(new_ids, domain, trials, seed, pkg=pkg):
                rng = np.random.default_rng(seed)
                docs = []
                for tid in new_ids:
                    doc = pkg.base.new_trial_doc(tid)
                    doc["misc"]["idxs"] = {"x": [tid]}
                    doc["misc"]["vals"] = {"x": [float(rng.uniform(-5, 5))]}
                    docs.append(doc)
                return docs

            t = pkg.PoolTrials(parallelism=1)
            extra = {"device": "cpu"} if pkg is ht else {}
            pkg.fmin(lambda d: (d["x"] - 1.0) ** 2, _space(pkg), algo=algo,
                     max_evals=5, trials=t, rstate=np.random.default_rng(8),
                     show_progressbar=False, **extra)
            runs.append([(d["tid"], d["state"], d["misc"]["vals"],
                          d["result"]["loss"]) for d in t])
        assert runs[0] == runs[1]


class TestCancellation:
    def test_process_timeout_kills_sleeping_objective(self):
        def fn(d):
            time.sleep(60)
            return d["x"] ** 2

        t = PoolTrials(parallelism=2, trial_timeout=0.5, execution="process")
        t0 = time.time()
        with pytest.raises(AllTrialsFailed):
            _fmin(fn, t, 2)
        assert time.time() - t0 < 20
        assert all(d["state"] == JOB_STATE_ERROR for d in t)
        assert all(d["misc"]["error"][0] == "Cancelled" for d in t)

    def test_process_execution_happy_path(self):
        def fn(d):
            return {"loss": (d["x"] - 1.0) ** 2, "status": "ok",
                    "attachments": {"note": b"from-child"}}

        t = PoolTrials(parallelism=2, execution="process")
        best = _fmin(fn, t, 8)
        assert all(d["state"] == JOB_STATE_DONE for d in t)
        assert "x" in best
        assert t.trial_attachments(t.trials[0])["note"] == b"from-child"

    def test_fmin_timeout_cancels_running(self):
        def fn(d):
            time.sleep(60)
            return 0.0

        t = PoolTrials(parallelism=2, execution="process")
        t0 = time.time()
        with pytest.raises(AllTrialsFailed):
            _fmin(fn, t, 4, timeout=1)
        assert time.time() - t0 < 25
        assert t.count_by_state_unsynced(JOB_STATE_ERROR) == len(t.trials)

    def test_thread_cooperative_cancel(self):
        released = threading.Event()

        def fn(expr=None, memo=None, ctrl=None):
            while not ctrl.should_stop():
                time.sleep(0.01)
            released.set()
            return {"loss": 0.0, "status": "ok"}

        fn.fmin_pass_expr_memo_ctrl = True
        t = PoolTrials(parallelism=1, trial_timeout=0.3, execution="thread")
        with pytest.raises(AllTrialsFailed):
            _fmin(fn, t, 1)
        assert released.wait(10)
        assert t.trials[0]["state"] == JOB_STATE_ERROR


class TestFMinIterProtocol:
    def test_step_iteration(self):
        d = Domain(lambda cfg: cfg["x"] ** 2, _space())
        d.cs.device = "cpu"
        it = FMinIter(rand.suggest, d, ht.Trials(), max_evals=5,
                      rstate=np.random.default_rng(0),
                      show_progressbar=False)
        assert list(it) == [1, 2, 3, 4, 5]

    def test_run_n_more(self):
        d = Domain(lambda cfg: cfg["x"] ** 2, _space())
        d.cs.device = "cpu"
        t = ht.Trials()
        it = FMinIter(rand.suggest, d, t, max_evals=10,
                      rstate=np.random.default_rng(0),
                      show_progressbar=False)
        it.run(3)
        assert len(t) == 3 and it.max_evals == 10
        it.run(20)
        assert len(t) == 10


# -- faults and retries (tests/test_faults.py) ----------------------------------


def test_process_mode_reforks_on_transient(tmp_path):
    """The child dies on a transient error; the watching thread charges the
    budget and forks a new child for the same point.  Each fork inherits a
    copy of the fault registry, so a file marks the first attempt."""
    marker = tmp_path / "first_attempt_done"

    def flaky(d):
        if not marker.exists():
            marker.write_text("x")
            raise TransientEvaluationError("child lost its device")
        return (d["x"] - 3.0) ** 2

    r0 = _counter("pool.trial_retries")
    pt = PoolTrials(parallelism=1, execution="process")
    _fmin(flaky, pt, 2, max_trial_retries=2)
    assert [d["state"] for d in pt] == [JOB_STATE_DONE] * 2
    assert pt._dynamic_trials[0]["misc"]["fail_count"] == 1
    assert "fail_count" not in pt._dynamic_trials[1]["misc"]
    assert _counter("pool.trial_retries") == r0 + 1


def test_budget_exhausted_marks_error():
    def always(d):
        raise TransientEvaluationError("never recovers")

    pt = PoolTrials(parallelism=1, execution="thread")
    with pytest.raises(AllTrialsFailed):
        _fmin(always, pt, 1, max_trial_retries=2, return_argmin=False)
    doc = pt._dynamic_trials[0]
    assert doc["state"] == JOB_STATE_ERROR
    assert doc["misc"]["error"][0] == "TransientEvaluationError"
    assert doc["misc"]["fail_count"] == 2


def _ignore_sigterm_and_sleep(ready):
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    ready.set()
    time.sleep(60)


def _adopt(pt, proc):
    pt._inflight.add(0)
    pt._cancel_events[0] = threading.Event()
    pt._procs[0] = proc


def test_cancel_escalates_to_sigkill(monkeypatch):
    monkeypatch.setattr(PoolTrials, "_TERM_GRACE_S", 0.2)
    pt = PoolTrials(parallelism=1, execution="process")
    ctx = multiprocessing.get_context("fork")
    ready = ctx.Event()
    proc = ctx.Process(target=_ignore_sigterm_and_sleep, args=(ready,),
                       daemon=True)
    proc.start()
    assert ready.wait(10.0)
    k0 = _counter("pool.cancel.sigkill")
    _adopt(pt, proc)
    assert pt._cancel_trial(0, "test-escalation") is True
    assert not proc.is_alive()
    assert _counter("pool.cancel.sigkill") == k0 + 1


def test_sigterm_honoured_without_escalation(monkeypatch):
    monkeypatch.setattr(PoolTrials, "_TERM_GRACE_S", 5.0)
    pt = PoolTrials(parallelism=1, execution="process")
    ctx = multiprocessing.get_context("fork")
    proc = ctx.Process(target=time.sleep, args=(60,), daemon=True)
    proc.start()
    k0 = _counter("pool.cancel.sigkill")
    _adopt(pt, proc)
    assert pt._cancel_trial(0, "test-graceful") is True
    assert not proc.is_alive()
    assert _counter("pool.cancel.sigkill") == k0


@pytest.mark.parametrize("execution", ["thread", "process"])
def test_completion_queue_cancel_all_drains_queued_work(execution):
    """One worker busy on the first item; ``cancel_all`` marks the two
    queued items, which come back ``"cancelled"``.  A thread finishes its
    item; a process-mode child is terminated and comes back an error."""
    gate, release = threading.Event(), threading.Event()

    def obj(d):
        gate.set()
        release.wait(30)
        return d["x"] ** 2

    dom = Domain(obj, _space())
    dom.cs.device = "cpu"
    t = ht.Trials()
    docs = rand.suggest(t.new_trial_ids(3), dom, t, 0)
    ev = CompletionQueueEvaluator(dom, n_workers=1, execution=execution)
    try:
        for doc in docs:
            ev.submit(doc, None)
        if execution == "thread":
            assert gate.wait(10.0)
        else:
            # The child has started (it has a pid) before anything is
            # cancelled.
            deadline = time.monotonic() + 10.0
            while not any(p.pid for p in list(ev._procs.values())) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert any(p.pid for p in list(ev._procs.values()))
        assert ev.cancel_all() == 2
        release.set()
        kinds = {}
        for _ in range(3):
            item, kind, _payload = ev.get(timeout=10.0)
            kinds[item.doc["tid"]] = kind
            ev.task_done(item)
        assert sorted(kinds.values()) == sorted(
            ["cancelled", "cancelled",
             "ok" if execution == "thread" else "error"])
        assert kinds[docs[0]["tid"]] != "cancelled"
    finally:
        release.set()
        ev.shutdown()


def test_pool_shutdown_forgets_the_history_rings():
    t = PoolTrials(parallelism=2)
    g0 = ht.history.generation(t)
    _fmin(lambda d: d["x"] ** 2, t, 3)
    assert ht.history.generation(t) == g0 + 1
