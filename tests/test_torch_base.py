"""Trials, Ctrl, Domain and the trial documents of the port, against the
JAX package.

Case for case the port's run of ``tests/test_base.py``.  Where a case
computes a value (id allocation, the best trial, state counts, the
idxs/vals round trip, ``spec_from_misc``, the dense history and in-flight
rows, ``Domain.evaluate``, ``average_best_error``) the same inputs, made
from a seed with numpy where they are random, go through both packages
and the results must be equal (``average_best_error`` within 1e-9, as the
JAX test holds it to its closed form).  The cases after those hold the
rest of the classic surface to JAX's: ``Trials.specs``, ``Ctrl.checkpoint``,
``Domain.short_str``/``true_loss``, the root's ``NetstoreUnavailable``,
``pipeline.MS_BUCKETS``, ``PipelinedExecutor(execution=)`` and
``FMinIter(verbose=)``.

Already held elsewhere, and not repeated here: the history's incremental
rebuild and ring (``tests/test_torch_history.py``), JAX docs carried over
with an equal history (``tests/test_torch_tpe.py::
test_trials_from_jax_docs_history_equal``), and the in-flight fantasies of
a liar batch (``tests/test_torch_liar.py``)."""

import copy
import pickle
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import base as base_j
from hyperopt_tpu_torch import base, hp
from hyperopt_tpu_torch.exceptions import AllTrialsFailed, InvalidTrial


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mk_doc(tid, loss=None, state=base.JOB_STATE_NEW, labels=("x",)):
    doc = base.new_trial_doc(tid)
    doc["misc"]["idxs"] = {k: [tid] for k in labels}
    doc["misc"]["vals"] = {k: [float(tid)] for k in labels}
    if loss is not None:
        doc["result"] = {"loss": loss, "status": ht.STATUS_OK}
        doc["state"] = base.JOB_STATE_DONE
    else:
        doc["state"] = state
    return doc


def _both(docs):
    """A port and a JAX ``Trials`` holding copies of ``docs``."""
    tt, tj = ht.Trials(), hj.Trials()
    tt.insert_trial_docs(copy.deepcopy(docs))
    tj.insert_trial_docs(copy.deepcopy(docs))
    tt.refresh()
    tj.refresh()
    return tt, tj


def _random_miscs(rng, n, labels=("a", "b", "c")):
    """``n`` misc dicts with each label active or not at random."""
    miscs = []
    for tid in rng.permutation(n * 3)[:n]:
        tid = int(tid)
        idxs, vals = {}, {}
        for k in labels:
            on = rng.random() < 0.6
            idxs[k] = [tid] if on else []
            vals[k] = [float(rng.normal())] if on else []
        miscs.append({"tid": tid, "cmd": None, "idxs": idxs, "vals": vals})
    return miscs


def test_validate_missing_key():
    doc = _mk_doc(0)
    del doc["misc"]["cmd"]
    with pytest.raises(InvalidTrial):
        base.validate_trial_docs([doc])


def test_validate_tid_mismatch():
    doc = _mk_doc(0)
    doc["misc"]["tid"] = 5
    with pytest.raises(InvalidTrial):
        base.validate_trial_docs([doc])


def test_validate_idxs_vals_mismatch():
    doc = _mk_doc(0)
    doc["misc"]["idxs"]["x"] = [0, 1]
    with pytest.raises(InvalidTrial):
        base.validate_trial_docs([doc])


def test_duplicate_tid_rejected():
    t = ht.Trials()
    t.insert_trial_docs([_mk_doc(0)])
    with pytest.raises(InvalidTrial):
        t.insert_trial_docs([_mk_doc(0)])


def test_new_trial_ids_monotonic():
    tt, tj = ht.Trials(), hj.Trials()
    got = []
    for t in (tt, tj):
        ids1 = t.new_trial_ids(3)
        t.insert_trial_docs([_mk_doc(i) for i in ids1])
        ids2 = t.new_trial_ids(2)
        assert ids2[0] > max(ids1)
        assert len(set(ids1 + ids2)) == 5
        got.append((ids1, ids2))
    assert got[0] == got[1]


def test_best_trial_and_argmin():
    tt, tj = _both([_mk_doc(0, loss=3.0), _mk_doc(1, loss=1.0),
                    _mk_doc(2, loss=2.0)])
    assert tt.best_trial["tid"] == 1
    assert tt.argmin == {"x": 1.0} == tj.argmin
    assert tt.losses() == [3.0, 1.0, 2.0] == tj.losses()
    assert tt.statuses() == tj.statuses()


def test_best_trial_requires_done_state():
    good = _mk_doc(0, loss=1.0)
    crashed = _mk_doc(1)
    crashed["state"] = base.JOB_STATE_ERROR
    crashed["result"] = {"loss": 0.0, "status": ht.STATUS_OK}
    tt, tj = _both([good, crashed])
    assert tt.best_trial["tid"] == 0 == tj.best_trial["tid"]


def test_all_trials_failed():
    t = ht.Trials()
    with pytest.raises(AllTrialsFailed):
        _ = t.best_trial


def test_count_by_state():
    tt, tj = _both([_mk_doc(0, loss=1.0), _mk_doc(1),
                    _mk_doc(2, state=base.JOB_STATE_RUNNING)])
    for t in (tt, tj):
        assert t.count_by_state_synced(base.JOB_STATE_DONE) == 1
        assert t.count_by_state_unsynced(
            (base.JOB_STATE_NEW, base.JOB_STATE_RUNNING)) == 2


def test_exp_key_filtering():
    t = ht.Trials(exp_key="A")
    doc_a = _mk_doc(0, loss=1.0)
    doc_a["exp_key"] = "A"
    doc_b = _mk_doc(1, loss=2.0)
    doc_b["exp_key"] = "B"
    t.insert_trial_docs([doc_a, doc_b])
    t.refresh()
    assert len(t) == 1 and t[0]["tid"] == 0


def test_miscs_round_trip():
    miscs = [{"tid": 0, "cmd": None, "idxs": {"x": [0], "y": []},
              "vals": {"x": [1.5], "y": []}},
             {"tid": 1, "cmd": None, "idxs": {"x": [1], "y": [1]},
              "vals": {"x": [2.5], "y": [7.0]}}]
    idxs, vals = base.miscs_to_idxs_vals(miscs)
    assert idxs == {"x": [0, 1], "y": [1]}
    assert vals == {"x": [1.5, 2.5], "y": [7.0]}
    blank = [{"tid": 0, "cmd": None, "idxs": {}, "vals": {}},
             {"tid": 1, "cmd": None, "idxs": {}, "vals": {}}]
    base.miscs_update_idxs_vals(blank, idxs, vals)
    assert blank[0]["vals"] == {"x": [1.5], "y": []}
    assert blank[1]["vals"] == {"x": [2.5], "y": [7.0]}


@pytest.mark.parametrize("seed", range(4))
def test_miscs_round_trip_matches_jax(seed):
    """Both directions on seeded misc dicts: equal columns, equal
    scattered miscs, and an unknown tid refused by both unless
    ``assert_all_vals_used=False``, which both then skip."""
    rng = np.random.default_rng(seed)
    miscs = _random_miscs(rng, 12)
    cols_t = base.miscs_to_idxs_vals(copy.deepcopy(miscs))
    cols_j = base_j.miscs_to_idxs_vals(copy.deepcopy(miscs))
    assert cols_t == cols_j
    keys = ["b", "a"]
    assert base.miscs_to_idxs_vals(miscs, keys=keys) == \
        base_j.miscs_to_idxs_vals(miscs, keys=keys)
    blank = [{"tid": m["tid"], "cmd": None, "idxs": {}, "vals": {}}
             for m in miscs]
    out_t = base.miscs_update_idxs_vals(copy.deepcopy(blank), *cols_t)
    out_j = base_j.miscs_update_idxs_vals(copy.deepcopy(blank), *cols_j)
    assert out_t == out_j
    assert [m["vals"] for m in out_t] == [m["vals"] for m in miscs]
    idxs, vals = copy.deepcopy(cols_t)
    idxs["a"].append(10_000)
    vals["a"].append(0.5)
    for mod in (base, base_j):
        with pytest.raises(ValueError):
            mod.miscs_update_idxs_vals(copy.deepcopy(blank), idxs, vals)
    assert base.miscs_update_idxs_vals(
        copy.deepcopy(blank), idxs, vals, assert_all_vals_used=False) == \
        base_j.miscs_update_idxs_vals(
            copy.deepcopy(blank), idxs, vals, assert_all_vals_used=False)


def test_spec_from_misc_skips_inactive():
    misc = {"tid": 0, "cmd": None, "idxs": {"x": [0], "y": []},
            "vals": {"x": [2.0], "y": []}}
    assert base.spec_from_misc(misc) == {"x": 2.0}
    for m in _random_miscs(np.random.default_rng(5), 20):
        assert base.spec_from_misc(m) == base_j.spec_from_misc(m)


def test_trials_pickle_round_trip():
    t = ht.Trials()
    t.insert_trial_docs([_mk_doc(0, loss=1.5)])
    t.refresh()
    t2 = pickle.loads(pickle.dumps(t))
    assert t2.best_trial["result"]["loss"] == 1.5
    t2.insert_trial_docs([_mk_doc(1, loss=0.5)])  # still usable (lock rebuilt)
    t2.refresh()
    assert t2.best_trial["tid"] == 1


def test_attachments():
    t = ht.Trials()
    doc = _mk_doc(0, loss=1.0)
    t.insert_trial_docs([doc])
    t.refresh()
    att = t.trial_attachments(t[0])
    att["blob"] = b"123"
    assert "blob" in att and att["blob"] == b"123"
    del att["blob"]
    assert "blob" not in att


def _cond_space(pkg):
    return {"c": pkg.hp.choice("c", [{"x": pkg.hp.uniform("x", 0, 1)},
                                     {"y": pkg.hp.uniform("y", 0, 1)}])}


def test_history_soa():
    d0 = base.new_trial_doc(0)
    d0["misc"]["idxs"] = {"c": [0], "x": [0], "y": []}
    d0["misc"]["vals"] = {"c": [0], "x": [0.25], "y": []}
    d0["result"] = {"loss": 0.5, "status": ht.STATUS_OK}
    d0["state"] = base.JOB_STATE_DONE
    d1 = base.new_trial_doc(1)
    d1["misc"]["idxs"] = {"c": [1], "x": [], "y": [1]}
    d1["misc"]["vals"] = {"c": [1], "x": [], "y": [0.75]}
    d1["result"] = {"status": ht.STATUS_FAIL}
    d1["state"] = base.JOB_STATE_DONE
    tt, tj = _both([d0, d1])
    cs, cs_j = ht.compile_space(_cond_space(ht)), hj.compile_space(
        _cond_space(hj))
    h, h_j = tt.history(cs), tj.history(cs_j)
    assert h["vals"].shape == (2, 3)
    px, py = cs.by_label["x"].pid, cs.by_label["y"].pid
    assert h["vals"][0, px] == np.float32(0.25)
    assert h["active"][0, px] and not h["active"][0, py]
    assert h["active"][1, py] and not h["active"][1, px]
    assert h["ok"][0] and not h["ok"][1]
    assert h["loss"][0] == np.float32(0.5) and np.isinf(h["loss"][1])
    for k in ("vals", "active", "loss", "ok", "tids"):
        np.testing.assert_array_equal(h[k], h_j[k])
        assert h[k].dtype == h_j[k].dtype
    # cache invalidation on refresh
    assert tt.history(cs) is h
    tt.insert_trial_docs([_mk_doc(2, loss=1.0, labels=("c",))])
    tt.refresh()
    assert tt.history(cs)["vals"].shape[0] == 3


def test_inflight_rows():
    d0 = base.new_trial_doc(0)                      # DONE: excluded
    d0["misc"]["idxs"] = {"c": [0], "x": [0], "y": []}
    d0["misc"]["vals"] = {"c": [0], "x": [0.25], "y": []}
    d0["result"] = {"loss": 0.5, "status": ht.STATUS_OK}
    d0["state"] = base.JOB_STATE_DONE
    d1 = base.new_trial_doc(1)                      # NEW: in flight
    d1["misc"]["idxs"] = {"c": [1], "x": [], "y": [1]}
    d1["misc"]["vals"] = {"c": [1], "x": [], "y": [0.75]}
    d1["state"] = base.JOB_STATE_NEW
    d2 = base.new_trial_doc(2)                      # RUNNING: in flight
    d2["misc"]["idxs"] = {"c": [2], "x": [2], "y": []}
    d2["misc"]["vals"] = {"c": [0], "x": [0.5], "y": []}
    d2["state"] = base.JOB_STATE_RUNNING
    tt, tj = _both([d0, d1, d2])
    cs = ht.compile_space(_cond_space(ht))
    pv, pa = tt.inflight(cs)
    px, py = cs.by_label["x"].pid, cs.by_label["y"].pid
    assert pv.shape == (2, 3)
    assert pa[0, py] and not pa[0, px]
    assert pv[0, py] == np.float32(0.75)
    assert pa[1, px] and not pa[1, py]
    pv_j, pa_j = tj.inflight(hj.compile_space(_cond_space(hj)))
    np.testing.assert_array_equal(pv, pv_j)
    np.testing.assert_array_equal(pa, pa_j)


def test_suggest_repels_inflight_points():
    """A suggest issued while another proposal is in flight moves off the
    in-flight point: the row enters the posterior as a fantasy."""
    space = {"x": hp.uniform("x", -5, 5)}

    def hist(n=24):
        t = ht.Trials()
        ids = t.new_trial_ids(n)
        rng = np.random.default_rng(0)
        docs = []
        for tid in ids:
            x = float(rng.uniform(-5, 5))
            d = base.new_trial_doc(tid)
            d["misc"]["idxs"] = {"x": [tid]}
            d["misc"]["vals"] = {"x": [x]}
            d["result"] = {"loss": (x - 3.0) ** 2, "status": ht.STATUS_OK}
            d["state"] = base.JOB_STATE_DONE
            docs.append(d)
        t.insert_trial_docs(docs)
        t.refresh()
        return t

    dom = base.Domain(lambda d: d["x"], space)
    dom.cs.device = "cpu"
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=64)
    t1 = hist()
    [doc_a] = algo(t1.new_trial_ids(1), dom, t1, 7)
    xa = doc_a["misc"]["vals"]["x"][0]
    t2 = hist()
    [d] = algo(t2.new_trial_ids(1), dom, t2, 7)
    t2.insert_trial_docs([d])
    t2.refresh()
    [doc_b] = algo(t2.new_trial_ids(1), dom, t2, 7)
    xb = doc_b["misc"]["vals"]["x"][0]
    assert xb != xa
    assert abs(xb - xa) > 1e-3


def test_domain_evaluate_normalization():
    for pkg in (ht, hj):
        d = pkg.Domain(lambda cfg: cfg["x"] * 2,
                       {"x": pkg.hp.uniform("x", 0, 1)})
        out = d.evaluate({"x": 0.5}, None)
        assert out == {"loss": 1.0, "status": ht.STATUS_OK}
        d2 = pkg.Domain(lambda cfg: {"loss": np.float32(1.0),
                                     "status": ht.STATUS_OK,
                                     "extra": "kept"},
                        {"x": pkg.hp.uniform("x", 0, 1)})
        out2 = d2.evaluate({"x": 0.5}, None)
        assert out2 == {"loss": 1.0, "status": ht.STATUS_OK,
                        "extra": "kept"}
        assert type(out2["loss"]) is float


def test_domain_evaluate_bad_status():
    d = ht.Domain(lambda cfg: {"status": "bogus"},
                  {"x": hp.uniform("x", 0, 1)})
    with pytest.raises(ht.exceptions.InvalidResultStatus):
        d.evaluate({"x": 0.5}, None)


def test_domain_evaluate_nonfinite_loss():
    d = ht.Domain(lambda cfg: float("nan"), {"x": hp.uniform("x", 0, 1)})
    with pytest.raises(ht.exceptions.InvalidLoss):
        d.evaluate({"x": 0.5}, None)


def test_domain_attachments_via_ctrl():
    def fn(cfg):
        return {"loss": 0.0, "status": ht.STATUS_OK,
                "attachments": {"model": b"weights"}}

    t = ht.Trials()
    doc = _mk_doc(0)
    t.insert_trial_docs([doc])
    t.refresh()
    d = ht.Domain(fn, {"x": hp.uniform("x", 0, 1)})
    ctrl = ht.Ctrl(t, current_trial=t[0])
    out = d.evaluate({"x": 0.5}, ctrl)
    assert "attachments" not in out
    assert t.trial_attachments(t[0])["model"] == b"weights"


def test_trials_from_docs():
    docs = [_mk_doc(0, loss=2.0), _mk_doc(1, loss=1.0)]
    t = base.trials_from_docs(docs)
    assert len(t) == 2 and t.best_trial["tid"] == 1


def test_average_best_error_variance_weighted():
    docs = []
    for tid, (loss, var) in enumerate([(1.0, 0.04), (1.1, 0.01),
                                       (5.0, 0.01)]):
        d = _mk_doc(tid, loss=loss)
        d["result"]["loss_variance"] = var
        docs.append(d)
    t = base.trials_from_docs(docs)
    # cutoff = 1.0 + 0.2 keeps losses 1.0 (w=25) and 1.1 (w=100); 5.0 is out
    want = (1.0 * 25 + 1.1 * 100) / 125
    assert abs(t.average_best_error() - want) < 1e-9
    t2 = base.trials_from_docs([_mk_doc(0, loss=2.0), _mk_doc(1, loss=3.0)])
    assert abs(t2.average_best_error() - 2.0) < 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_average_best_error_matches_jax(seed):
    """Seeded losses and variances (some trials without a variance, some
    failed): the two packages agree within 1e-9."""
    rng = np.random.default_rng(seed)
    docs = []
    for tid in range(16):
        d = _mk_doc(tid, loss=float(rng.normal(1.0, 0.3)))
        if rng.random() < 0.7:
            d["result"]["loss_variance"] = float(rng.uniform(0.0, 0.05))
        if rng.random() < 0.2:
            d["result"] = {"status": ht.STATUS_FAIL}
        docs.append(d)
    tt, tj = _both(docs)
    assert abs(tt.average_best_error() - tj.average_best_error()) < 1e-9


def test_average_best_error_no_ok_trials():
    t = ht.Trials()
    t.insert_trial_docs([_mk_doc(0, state=base.JOB_STATE_NEW)])
    t.refresh()
    with pytest.raises(ht.AllTrialsFailed):
        t.average_best_error()


# -- the rest of the classic surface ----------------------------------------


def test_specs_follow_the_docs():
    """``new_trial_doc`` and ``docs_from_samples`` leave ``spec`` as JAX's
    do, and ``Trials.specs`` lists it in trial order."""
    assert base.new_trial_doc(3, exp_key="e", cmd=("x",)) == \
        base_j.new_trial_doc(3, exp_key="e", cmd=("x",))
    rng = np.random.default_rng(0)
    cs, cs_j = ht.compile_space(_cond_space(ht)), hj.compile_space(
        _cond_space(hj))
    vals = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    vals[:, cs.by_label["c"].pid] = [0, 1, 1, 0]
    active = cs.active_mask_host(vals)
    docs = base.docs_from_samples(cs, [0, 1, 2, 3], vals, active)
    docs_j = base_j.docs_from_samples(cs_j, [0, 1, 2, 3], vals, active)
    assert docs == docs_j
    docs[2]["spec"] = {"note": "set by a caller"}
    docs_j[2]["spec"] = {"note": "set by a caller"}
    tt, tj = _both(docs)
    assert tt.specs == tj.specs == [None, None, {"note": "set by a caller"},
                                    None]


def test_ctrl_checkpoint_matches_jax():
    docs = [_mk_doc(0)]
    tt, tj = _both(docs)
    partial_result = {"status": ht.STATUS_RUNNING, "loss": 0.7}
    for t, pkg in ((tt, ht), (tj, hj)):
        ctrl = pkg.Ctrl(t, current_trial=t[0])
        ctrl.checkpoint()                       # no result: no change
        assert t[0]["result"] == {"status": ht.STATUS_NEW}
        assert t[0]["refresh_time"] is None
        ctrl.checkpoint(dict(partial_result))
        assert t[0]["result"] == partial_result
        assert isinstance(t[0]["refresh_time"], float)
        pkg.Ctrl(t).checkpoint({"status": "ok"})  # no trial: no change
        assert t[0]["result"] == partial_result
    strip = [{k: v for k, v in d.items() if k != "refresh_time"}
             for d in tt]
    assert strip == [{k: v for k, v in d.items() if k != "refresh_time"}
                     for d in tj]


def test_domain_short_str_and_true_loss():
    for make in (lambda pkg: {"x": pkg.hp.uniform("x", 0, 1)}, _cond_space):
        dt = ht.Domain(lambda c: 0.0, make(ht))
        dj = hj.Domain(lambda c: 0.0, make(hj))
        assert dt.short_str() == dj.short_str()
        assert dt.short_str().startswith("Domain{CompiledSpace(P=")
    for result in ({"loss": 2.0}, {"loss": 2.0, "true_loss": 1.5}, {}):
        assert ht.Domain.true_loss(result) == hj.Domain.true_loss(result)
        assert dt.true_loss(result, config={"x": 0.1}) == \
            dj.true_loss(result, config={"x": 0.1})
    assert ht.Domain.rec_eval_print_node_on_error is \
        hj.Domain.rec_eval_print_node_on_error


def test_package_root_exports_netstore_unavailable():
    from hyperopt_tpu_torch import exceptions

    assert ht.NetstoreUnavailable is exceptions.NetstoreUnavailable
    assert "NetstoreUnavailable" in ht.__all__
    assert set(hj.__all__) <= set(ht.__all__)
    assert issubclass(ht.NetstoreUnavailable, ht.HyperoptTpuError)
    assert exceptions.is_transient(ht.NetstoreUnavailable("down")) == \
        hj.exceptions.is_transient(hj.NetstoreUnavailable("down"))


def test_ms_buckets_equal_jax():
    from hyperopt_tpu import pipeline as pipeline_j
    from hyperopt_tpu_torch import pipeline, tpe

    assert pipeline.MS_BUCKETS == pipeline_j.MS_BUCKETS
    assert tpe._MS_BUCKETS == pipeline.MS_BUCKETS


def test_fmin_iter_stores_verbose():
    for pkg in (ht, hj):
        dom = pkg.Domain(lambda c: 0.0, {"x": pkg.hp.uniform("x", 0, 1)})
        dom.cs.device = "cpu"
        it = pkg.FMinIter(pkg.rand.suggest, dom, pkg.Trials(), max_evals=1,
                          verbose=True)
        assert it.verbose is True
        assert pkg.FMinIter(pkg.rand.suggest, dom, pkg.Trials(),
                            max_evals=1).verbose is False


def _quad(cfg):
    import os

    return {"loss": (cfg["x"] - 1.0) ** 2 + cfg["y"] ** 2,
            "status": ht.STATUS_OK, "pid": os.getpid()}


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_executor_process_execution_lands_the_thread_trials(depth):
    """``PipelinedExecutor(execution="process")`` hands the evaluator
    forked children (each trial's objective reports its pid); with one
    evaluator the run lands the trials the ``"thread"`` evaluator lands:
    the same tids, points and losses."""
    import os

    from hyperopt_tpu_torch.fmin import FMinIter
    from hyperopt_tpu_torch.pipeline import PipelinedExecutor

    space = {"x": hp.uniform("x", -3, 3), "y": hp.uniform("y", -3, 3)}
    algo = partial(ht.tpe.suggest, n_startup_jobs=6, n_EI_candidates=16)
    landed = {}
    for execution in ("thread", "process"):
        dom = ht.Domain(_quad, space)
        dom.cs.device = "cpu"
        trials = ht.Trials()
        it = FMinIter(algo, dom, trials, rstate=np.random.default_rng(3),
                      max_evals=10, show_progressbar=False,
                      overlap_depth=depth)
        pipe = it._pipeline
        it._pipeline = PipelinedExecutor(
            it, depth=pipe.depth, evaluators=pipe.evaluators,
            dispatch=pipe._dispatch, materialize=pipe._materialize,
            handle_ready=pipe._handle_ready,
            start_transfer=pipe._start_transfer, execution=execution)
        assert it._pipeline.execution == execution
        it.exhaust()
        assert all(d["state"] == base.JOB_STATE_DONE for d in trials)
        pids = {d["result"]["pid"] for d in trials}
        if execution == "thread":
            assert pids == {os.getpid()}
        else:
            assert os.getpid() not in pids and len(pids) == len(trials)
        landed[execution] = sorted(
            (d["tid"], d["misc"]["vals"], d["result"]["loss"])
            for d in trials)
    assert len(landed["thread"]) == 10
    assert landed["process"] == landed["thread"]
