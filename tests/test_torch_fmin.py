"""``fmin`` of the PyTorch port, case for case with ``tests/test_fmin.py``.

Every case of the JAX file runs here on the port at ``device="cpu"``:
points_to_evaluate, trials_save_file resume (pickle and JSON), early
stop, timeout, loss_threshold, exception propagation, space_eval round
trips, the constant-liar batches at ``max_queue_len`` 4, 8 and 32, the
overlapped suggest (``TestOverlapSuggest``), the algo aliases
(``TestAlgoAliases``) and ``suggest_quantile`` with overlap.

Against the JAX package, where both write the same thing:

* a JSON ``trials_save_file`` written by either package resumes in the
  other, with the writer's docs first;
* ``generate_trials_to_calculate`` gives JAX's docs;
* ``points_to_evaluate`` runs first in both, with the same rows.
"""

import json
import os
import pickle
import time
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import hp, rand
from zoo_torch import ZOO

CPU = "cpu"
SPACE1 = {"x": hp.uniform("x", -5, 5)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fmin(*args, **kwargs):
    """The port's ``fmin`` on the CPU."""
    kwargs.setdefault("device", CPU)
    return ht.fmin(*args, **kwargs)


def q1(d):
    return (d["x"] - 3.0) ** 2


def test_fmin_rand_converges():
    best = fmin(q1, SPACE1, algo=rand.suggest, max_evals=150, rstate=1,
                show_progressbar=False)
    assert abs(best["x"] - 3.0) < 0.5


def test_fmin_seeded_reproducible():
    kw = dict(algo=rand.suggest, max_evals=20, show_progressbar=False)
    b1 = fmin(q1, SPACE1, rstate=np.random.default_rng(7), **kw)
    b2 = fmin(q1, SPACE1, rstate=np.random.default_rng(7), **kw)
    assert b1 == b2


def test_fmin_trials_populated():
    trials = ht.Trials()
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=17, trials=trials,
         rstate=0, show_progressbar=False)
    assert len(trials) == 17
    assert all(s == ht.STATUS_OK for s in trials.statuses())
    assert trials.best_trial["result"]["loss"] == min(trials.losses())


def test_points_to_evaluate_run_first():
    pts = [{"x": 3.0}, {"x": -3.0}]
    seen = []
    out = fmin(lambda d: seen.append(d["x"]) or q1(d), SPACE1,
               algo=rand.suggest, max_evals=5, points_to_evaluate=pts,
               rstate=0, show_progressbar=False)
    assert seen[:2] == [3.0, -3.0]
    assert out == {"x": 3.0}


def test_points_to_evaluate_conditional_space():
    space = {"m": hp.choice("m", [
        {"kind": "linear", "lr": hp.uniform("lr_lin", 0.0, 1.0)},
        {"kind": "tree", "depth": hp.uniformint("depth", 1, 8)}])}

    def fn(cfg):
        m = cfg["m"]
        return m["lr"] if m["kind"] == "linear" else m["depth"] * 0.1

    pts = [{"m": 0, "lr_lin": 0.25}, {"m": 1, "depth": 3}]
    t = ht.generate_trials_to_calculate(pts)
    fmin(fn, space, algo=rand.suggest, max_evals=4, trials=t, rstate=0,
         show_progressbar=False)
    v0, v1 = t[0]["misc"]["vals"], t[1]["misc"]["vals"]
    assert v0["m"] == [0] and v0["lr_lin"] == [0.25]
    assert v0.get("depth", []) == []
    assert v1["m"] == [1] and v1["depth"] == [3]
    assert v1.get("lr_lin", []) == []
    assert abs(t[0]["result"]["loss"] - 0.25) < 1e-6
    assert abs(t[1]["result"]["loss"] - 0.3) < 1e-6
    cfg = ht.space_eval(space, {"m": 0, "lr_lin": 0.25})
    assert cfg["m"]["kind"] == "linear" and cfg["m"]["lr"] == 0.25


def test_generate_trials_to_calculate():
    t = ht.generate_trials_to_calculate([{"x": 1.0}, {"x": 2.0}])
    assert len(t) == 2
    assert t[0]["misc"]["vals"] == {"x": [1.0]}


def test_trials_save_file_resume(tmp_path):
    path = str(tmp_path / "trials.pkl")
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=10, rstate=0,
         trials_save_file=path, show_progressbar=False)
    assert os.path.exists(path)
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=25, rstate=1,
         trials_save_file=path, show_progressbar=False, return_argmin=False)
    with open(path, "rb") as f:
        trials = pickle.load(f)
    assert len(trials) == 25


def test_trials_save_file_json_resume(tmp_path):
    path = str(tmp_path / "trials.json")
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=10, rstate=0,
         trials_save_file=path, show_progressbar=False)
    with open(path) as f:
        payload = json.load(f)
    assert len(payload["docs"]) == 10
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=25, rstate=1,
         trials_save_file=path, show_progressbar=False, return_argmin=False)
    with open(path) as f:
        payload = json.load(f)
    assert len(payload["docs"]) == 25
    losses = [d["result"]["loss"] for d in payload["docs"]]
    assert all(isinstance(x, float) for x in losses)


def test_trials_save_file_json_numpy_payload(tmp_path):
    path = str(tmp_path / "trials.json")

    def fn(d):
        return {"loss": d["x"] ** 2, "status": "ok",
                "np_scalar": np.float32(1.5), "np_int": np.int64(7),
                "np_arr": np.arange(3.0)}

    fmin(fn, SPACE1, algo=rand.suggest, max_evals=4, rstate=0,
         trials_save_file=path, show_progressbar=False)
    with open(path) as f:
        doc = json.load(f)["docs"][0]
    assert doc["result"]["np_scalar"] == 1.5
    assert doc["result"]["np_int"] == 7
    assert doc["result"]["np_arr"] == [0.0, 1.0, 2.0]

    bad = str(tmp_path / "bad.json")
    with pytest.raises(TypeError, match="non-JSON-serializable"):
        fmin(lambda d: {"loss": 0.0, "status": "ok", "blob": object()},
             SPACE1, algo=rand.suggest, max_evals=1, rstate=0,
             trials_save_file=bad, show_progressbar=False)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_early_stop_no_progress():
    calls = []

    def fn(d):
        calls.append(1)
        return 1.0

    fmin(fn, SPACE1, algo=rand.suggest, max_evals=500, rstate=0,
         early_stop_fn=ht.no_progress_loss(10), show_progressbar=False)
    assert len(calls) < 50


def test_timeout():
    def slow(d):
        time.sleep(0.02)
        return d["x"] ** 2

    t0 = time.time()
    fmin(slow, SPACE1, algo=rand.suggest, max_evals=10000, timeout=0.5,
         rstate=0, show_progressbar=False)
    assert time.time() - t0 < 5.0


def test_loss_threshold():
    trials = ht.Trials()
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=5000, loss_threshold=5.0,
         trials=trials, rstate=0, show_progressbar=False)
    assert len(trials) < 5000
    assert trials.best_trial["result"]["loss"] <= 5.0


def test_invalid_timeout_rejected():
    with pytest.raises(Exception):
        fmin(q1, SPACE1, algo=rand.suggest, max_evals=3, timeout=-1,
             show_progressbar=False)


def test_exception_propagates_by_default():
    def bad(d):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        fmin(bad, SPACE1, algo=rand.suggest, max_evals=3, rstate=0,
             show_progressbar=False)


def test_catch_eval_exceptions():
    def flaky(d):
        if d["x"] < 0:
            raise RuntimeError("boom")
        return d["x"]

    trials = ht.Trials()
    fmin(flaky, SPACE1, algo=rand.suggest, max_evals=30, rstate=0,
         catch_eval_exceptions=True, trials=trials, show_progressbar=False)
    states = [t["state"] for t in trials]
    assert ht.JOB_STATE_ERROR in states and ht.JOB_STATE_DONE in states


def test_fail_status_trials_skipped_in_argmin():
    def fn(d):
        if d["x"] < 0:
            return {"status": ht.STATUS_FAIL}
        return {"loss": d["x"], "status": ht.STATUS_OK}

    trials = ht.Trials()
    fmin(fn, SPACE1, algo=rand.suggest, max_evals=40, rstate=0,
         trials=trials, show_progressbar=False)
    assert trials.best_trial["result"]["loss"] >= 0


def test_return_argmin_false_returns_loss():
    out = fmin(q1, SPACE1, algo=rand.suggest, max_evals=10, rstate=0,
               return_argmin=False, show_progressbar=False)
    assert isinstance(out, float)


def test_fmin_via_trials_method():
    trials = ht.Trials()
    best = trials.fmin(q1, SPACE1, algo=rand.suggest, max_evals=10,
                       rstate=0, show_progressbar=False, device=CPU)
    assert "x" in best and len(trials) == 10


def test_space_eval_on_argmin_conditional():
    z = ZOO["q1_choice"]
    trials = ht.Trials()
    best = fmin(z.fn, z.space, algo=rand.suggest, max_evals=30, rstate=0,
                trials=trials, show_progressbar=False)
    cfg = ht.space_eval(z.space, best)
    assert np.isfinite(z.fn(cfg))


def test_pass_expr_memo_ctrl():
    seen = {}

    def fn(expr, memo, ctrl):
        seen["memo"] = memo
        seen["ctrl"] = ctrl
        return {"loss": memo["x"] ** 2, "status": ht.STATUS_OK}

    fn.fmin_pass_expr_memo_ctrl = True
    fmin(fn, SPACE1, algo=rand.suggest, max_evals=3, rstate=0,
         show_progressbar=False)
    assert "x" in seen["memo"] and isinstance(seen["ctrl"], ht.Ctrl)


def test_fmin_pass_expr_memo_ctrl_decorator():
    @ht.fmin_pass_expr_memo_ctrl
    def fn(expr, memo, ctrl):
        return {"loss": memo["x"] ** 2, "status": ht.STATUS_OK}

    assert fn.fmin_pass_expr_memo_ctrl is True
    trials = ht.Trials()
    fmin(fn, SPACE1, algo=rand.suggest, max_evals=3, rstate=0,
         trials=trials, show_progressbar=False)
    assert len(trials) == 3
    assert all(t["result"]["status"] == ht.STATUS_OK for t in trials)


def test_fmin_with_exp_key_trials():
    trials = ht.Trials(exp_key="exp-A")
    best = fmin(q1, SPACE1, algo=rand.suggest, max_evals=8, trials=trials,
                rstate=0, show_progressbar=False)
    assert len(trials) == 8 and "x" in best
    assert all(t["exp_key"] == "exp-A" for t in trials)


def test_max_queue_len_batched_suggest():
    trials = ht.Trials()
    fmin(q1, SPACE1, algo=rand.suggest, max_evals=12, max_queue_len=4,
         trials=trials, rstate=0, show_progressbar=False)
    assert len(trials) == 12


def test_max_queue_len_batched_tpe():
    """Past startup, ``max_queue_len=8`` runs the constant-liar batch: the
    fantasy refits spread each batch across the space (independent draws
    from one posterior collapse onto one peak) and the run converges."""
    trials = ht.Trials()
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=32)
    best = fmin(q1, SPACE1, algo=algo, max_evals=32, max_queue_len=8,
                trials=trials, rstate=np.random.default_rng(0),
                show_progressbar=False)
    assert len(trials) == 32
    xs_all = [d["misc"]["vals"]["x"][0] for d in trials.trials]
    assert len(set(xs_all[24:32])) == 8
    for lo in (8, 16, 24):
        batch = xs_all[lo:lo + 8]
        assert max(batch) - min(batch) > 2.0
    assert q1(best) < 1.0


def test_max_queue_len_deep_batch_q32():
    """A 32-deep liar scan: the first 32 ids are startup draws, then full
    batches of 32 distinct proposals spanning the domain."""
    trials = ht.Trials()
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=32)
    fmin(q1, SPACE1, algo=algo, max_evals=96, max_queue_len=32,
         trials=trials, rstate=np.random.default_rng(0),
         show_progressbar=False)
    assert len(trials) == 96
    xs_all = [d["misc"]["vals"]["x"][0] for d in trials.trials]
    for lo in (32, 64):
        batch = xs_all[lo:lo + 32]
        assert len(set(batch)) == 32
        assert max(batch) - min(batch) > 2.0


def test_max_queue_len_partial_final_batch():
    """``max_evals`` not a multiple of ``max_queue_len``: the last partial
    batch completes with exactly ``max_evals`` trials."""
    trials = ht.Trials()
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=32)
    fmin(q1, SPACE1, algo=algo, max_evals=30, max_queue_len=8,
         trials=trials, rstate=np.random.default_rng(0),
         show_progressbar=False)
    assert len(trials) == 30
    assert all(len(d["misc"]["vals"]["x"]) == 1 for d in trials.trials)


class TestOverlapSuggest:
    """The next suggest is dispatched while the host evaluates
    (``fmin(overlap_suggest=True)``)."""

    def test_overlap_converges_and_counts(self):
        t = ht.Trials()
        fmin(lambda d: (d["x"] - 3.0) ** 2, {"x": hp.uniform("x", -5, 5)},
             algo=ht.tpe.suggest, max_evals=50, trials=t,
             rstate=np.random.default_rng(0), show_progressbar=False,
             overlap_suggest=True)
        assert len(t) == 50
        assert all(d["state"] == ht.JOB_STATE_DONE for d in t)
        assert t.best_trial["result"]["loss"] < 0.5
        assert sorted(d["tid"] for d in t) == list(range(50))

    def test_overlap_with_partial_bound_algo(self):
        t = ht.Trials()
        algo = ht.partial(ht.tpe.suggest, n_EI_candidates=64, gamma=0.3)
        fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -2, 2)},
             algo=algo, max_evals=40, trials=t,
             rstate=np.random.default_rng(1), show_progressbar=False,
             overlap_suggest=True)
        assert len(t) == 40
        assert t.best_trial["result"]["loss"] < 0.5

    def test_overlap_batched(self):
        """Overlap with ``max_queue_len > 1``, a partial final batch
        included: counts, states and tids stay exact."""
        t = ht.Trials()
        algo = ht.partial(ht.tpe.suggest, n_startup_jobs=8,
                          n_EI_candidates=32)
        fmin(lambda d: (d["x"] - 3.0) ** 2, {"x": hp.uniform("x", -5, 5)},
             algo=algo, max_evals=36, max_queue_len=8, trials=t,
             rstate=np.random.default_rng(0), show_progressbar=False,
             overlap_suggest=True)
        assert len(t) == 36
        assert all(d["state"] == ht.JOB_STATE_DONE for d in t)
        assert sorted(d["tid"] for d in t) == list(range(36))

    def test_clamped_resume_pending_batch(self):
        """Stop with a dispatched batch in flight, then resume with a
        smaller budget: the discarded handle's tids were never inserted,
        so the resume allocates from the largest existing tid with no gap
        and no duplicate."""
        from hyperopt_tpu_torch.base import Domain
        from hyperopt_tpu_torch.fmin import FMinIter

        t = ht.Trials()
        algo = ht.partial(ht.tpe.suggest, n_startup_jobs=2,
                          n_EI_candidates=16)
        d = Domain(lambda cfg: (cfg["x"] - 1.0) ** 2,
                   {"x": hp.uniform("x", -5, 5)})
        d.cs.device = CPU
        armed = {"stop": True}

        def early_stop(trials, *args):
            return armed["stop"], ()

        it = FMinIter(algo, d, t, rstate=np.random.default_rng(0),
                      max_queue_len=4, overlap_suggest=True,
                      show_progressbar=False, early_stop_fn=early_stop)
        it.run(8)
        assert it.n_done() == 4
        assert sorted(doc["tid"] for doc in t) == list(range(4))

        it.early_stop_fn = None
        armed["stop"] = False
        it.run(2)
        assert it.n_done() == 6
        assert sorted(doc["tid"] for doc in t) == list(range(6))

        it.run(3)
        tids = sorted(doc["tid"] for doc in t)
        assert len(tids) == len(set(tids)) == 9
        assert all(d_["state"] == ht.JOB_STATE_DONE for d_ in t)

    def test_overlap_ignored_for_non_dispatch_algo(self):
        t = ht.Trials()
        fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -2, 2)},
             algo=rand.suggest, max_evals=10, trials=t,
             rstate=np.random.default_rng(0), show_progressbar=False,
             overlap_suggest=True)
        assert len(t) == 10


class TestAlgoAliases:
    def test_string_algos(self):
        for name in ("tpe", "rand", "anneal", "tpe_mv"):
            t = ht.Trials()
            fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -2, 2)},
                 algo=name, max_evals=8, trials=t,
                 rstate=np.random.default_rng(0), show_progressbar=False)
            assert len(t) == 8, name

    def test_qmc_family_aliases(self):
        for name in ("qmc", "sobol", "halton", "tpe_sobol"):
            t = ht.Trials()
            fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -2, 2)},
                 algo=name, max_evals=5, trials=t,
                 rstate=np.random.default_rng(0), show_progressbar=False)
            assert len(t) == 5, name

    def test_unknown_alias_raises(self):
        with pytest.raises(ValueError):
            fmin(lambda d: 0.0, {"x": hp.uniform("x", 0, 1)}, algo="nope",
                 max_evals=1, show_progressbar=False)

    def test_timeout_and_threshold_validation(self):
        with pytest.raises(Exception):
            fmin(lambda d: 0.0, {"x": hp.uniform("x", 0, 1)}, algo="rand",
                 max_evals=1, timeout=-3, show_progressbar=False)
        with pytest.raises(Exception):
            fmin(lambda d: 0.0, {"x": hp.uniform("x", 0, 1)}, algo="rand",
                 max_evals=1, loss_threshold="low", show_progressbar=False)


def test_overlap_with_suggest_quantile():
    t = ht.Trials()
    fmin(lambda d: (d["x"] + 1.0) ** 2, {"x": hp.uniform("x", -4, 4)},
         algo=ht.tpe.suggest_quantile, max_evals=40, trials=t,
         rstate=np.random.default_rng(0), show_progressbar=False,
         overlap_suggest=True)
    assert len(t) == 40
    assert t.best_trial["result"]["loss"] < 0.5


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _run(pkg, path, max_evals, seed):
    kw = {"device": CPU} if pkg is ht else {}
    pkg.fmin(q1, {"x": pkg.hp.uniform("x", -5, 5)}, algo=pkg.rand.suggest,
             max_evals=max_evals, rstate=np.random.default_rng(seed),
             trials_save_file=path, show_progressbar=False, **kw)
    with open(path) as f:
        return json.load(f)["docs"]


@pytest.mark.parametrize("writer, reader", [(hj, ht), (ht, hj)],
                         ids=["jax_to_port", "port_to_jax"])
def test_json_save_file_resumes_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "trials.json")
    first = _run(writer, path, 10, 0)
    docs = _run(reader, path, 25, 1)
    assert len(docs) == 25 and docs[:10] == first
    assert sorted(d["tid"] for d in docs) == list(range(25))


def test_generate_trials_to_calculate_gives_jax_docs():
    pts = [{"x": 1.0}, {"m": 1, "depth": 3}, {"m": 0, "lr_lin": 0.25}]
    want = list(hj.generate_trials_to_calculate(pts, exp_key="e"))
    got = list(ht.generate_trials_to_calculate(pts, exp_key="e"))
    assert got == want


def test_points_to_evaluate_run_first_in_order_in_both_packages():
    """The given points are the first three evaluations of both
    packages, in the order given; the budget's other three are drawn."""
    pts = [{"x": 3.0}, {"x": -3.0}, {"x": 0.5}]
    seen, best = {}, {}
    for pkg in (hj, ht):
        kw = {"device": CPU} if pkg is ht else {}
        seen[pkg] = []
        best[pkg] = pkg.fmin(lambda d, s=seen[pkg]: s.append(d["x"]) or q1(d),
                             {"x": pkg.hp.uniform("x", -5, 5)},
                             algo=pkg.rand.suggest, max_evals=6,
                             points_to_evaluate=pts, rstate=0,
                             show_progressbar=False, **kw)
    assert seen[ht][:3] == seen[hj][:3] == [3.0, -3.0, 0.5]
    assert len(seen[ht]) == len(seen[hj]) == 6
    assert all(-5 <= x <= 5 and x not in (3.0, -3.0, 0.5)
               for x in seen[ht][3:] + seen[hj][3:])
    # 3.0 is the optimum, so both report it
    assert best[ht] == best[hj] == {"x": 3.0}
