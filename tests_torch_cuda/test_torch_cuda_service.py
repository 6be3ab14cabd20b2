"""The suggestion service on the card (the CPU half:
``tests/test_torch_service.py`` and ``test_torch_service_store.py``): a
cohort-gate window of three tenants equals their solo rows bit for bit
with one fleet dispatch and one K1 launch; a scheduler made to raise sends
the window down the solo path with equal rows and logs the failure;
recovery of a log holding server-side suggests launches no kernel; and the
store's columns feed the resident ring on the card with the new rows only
and no stale row after the columns regrow."""

import json
import logging
import threading

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import base, fleet, history, rand, tpe
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.ops import ei_scores as ek
from hyperopt_tpu_torch.parallel.netstore import NetTrials
from hyperopt_tpu_torch.service.server import ServiceServer

SPACE = {"x": ht.hp.uniform("x", -5, 5), "lr": ht.hp.loguniform("lr", -6, 0),
         "q": ht.hp.quniform("q", 0, 20, 2),
         "c": ht.hp.choice("c", [0, 1, 2])}
N_TENANTS = 3
TIMEOUT = 60.0


def _objective(cfg):
    return (cfg["x"] - 1.0) ** 2 + cfg["q"]


def _graphs():
    snap = registry().snapshot()["counters"]
    return {k: snap.get(f"tpe.graph.{k}", 0.0)
            for k in ("captures", "replays", "eager_steps")}


def _history(n, seed, exp_key):
    dom = ht.Domain(_objective, SPACE)
    dom.cs.device = None        # no device: CUDA, here and on the server
    docs = rand.suggest(list(range(n)), dom, ht.Trials(), seed)
    rng = np.random.default_rng(seed)
    for d in docs:
        d["state"] = base.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
        d["exp_key"] = exp_key
    return dom, json.loads(json.dumps(docs))


def _tenants(srv, n):
    out = []
    for e in range(n):
        dom, docs = _history(40 + e, 10 + e, f"e{e}")
        nt = NetTrials(srv.url, exp_key=f"e{e}", timeout=TIMEOUT)
        nt.save_domain(dom)
        nt.insert_trial_docs(docs)
        local = base.trials_from_docs(json.loads(json.dumps(docs)),
                                      exp_key=f"e{e}")
        out.append((dom, nt, local))
    return out


def _window(tenants, seeds):
    got = [None] * len(tenants)

    def call(e):
        got[e] = tenants[e][1].suggest(seeds[e], new_ids=[500],
                                       insert=False)

    ts = [threading.Thread(target=call, args=(e,))
          for e in range(len(tenants))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    return got


@pytest.fixture
def gated(tmp_path):
    srv = ServiceServer(str(tmp_path / "wal"), fsync="never",
                        cohort_window_ms=200)
    srv.start()
    yield srv
    srv.shutdown()


@pytest.mark.cuda
def test_gate_window_equals_solo_rows_with_one_k1_launch(gated):
    tenants = _tenants(gated, N_TENANTS)
    seeds = [700 + e for e in range(N_TENANTS)]
    solo = [json.loads(json.dumps(tpe.suggest([500], dom, local, s,
                                              verbose=False)))
            for (dom, _, local), s in zip(tenants, seeds)]
    for w in range(2):      # the second window rides the resident lanes
        d0 = fleet.dispatches
        ek.reset_launches()
        got = _window(tenants, seeds)
        by = dict(ek.ei_scores.launches_by)
        assert got == solo
        assert fleet.dispatches == d0 + 1
        assert by == {k: int(k == "f32") for k in by}, by


@pytest.mark.cuda
def test_failed_dispatch_goes_solo_with_equal_rows_and_logs(
        gated, monkeypatch, caplog):
    tenants = _tenants(gated, N_TENANTS)
    seeds = [800 + e for e in range(N_TENANTS)]
    solo = [json.loads(json.dumps(tpe.suggest([500], dom, local, s,
                                              verbose=False)))
            for (dom, _, local), s in zip(tenants, seeds)]

    def broken(self, requests):
        raise RuntimeError("scheduler made to raise")

    monkeypatch.setattr(fleet.CohortScheduler, "suggest_dispatch", broken)
    d0 = fleet.dispatches
    ek.reset_launches()
    g0 = _graphs()
    with caplog.at_level(logging.ERROR,
                         logger="hyperopt_tpu_torch.service.server"):
        got = _window(tenants, seeds)
    g = {k: _graphs()[k] - g0[k] for k in g0}
    assert got == solo
    assert fleet.dispatches == d0
    # K1 once per solo step: launched eagerly (a kernel's first step), or
    # replayed from the hosted step graph, which recorded it once while
    # its capture's warm-up launched it once.
    eager = N_TENANTS - g["replays"]
    assert 0 <= eager <= N_TENANTS and g["captures"] <= g["replays"]
    assert ek.ei_scores.recorded_by == {
        k: g["captures"] * (k == "f32") for k in ek.ei_scores.recorded_by}
    assert ek.ei_scores.launches_by == {
        k: (eager + g["captures"]) * (k == "f32")
        for k in ek.ei_scores.launches_by}
    assert g["eager_steps"] == 0
    assert any("cohort gate dispatch failed" in r.getMessage()
               for r in caplog.records)


@pytest.mark.cuda
def test_recovery_launches_no_kernel(tmp_path):
    wal_dir = str(tmp_path / "wal")
    srv = ServiceServer(wal_dir, fsync="never", cohort_window_ms=100)
    srv.start()
    try:
        tenants = _tenants(srv, 2)
        for e, (_, nt, _) in enumerate(tenants):
            nt.suggest(900 + e, n=2)
        _window(tenants, [910, 911])
        live = srv.state_bytes()
    finally:
        srv.shutdown()
    ek.reset_launches()
    d0 = fleet.dispatches
    srv2 = ServiceServer(wal_dir)
    try:
        assert srv2.state_bytes() == live
    finally:
        srv2.shutdown()
    assert sum(ek.ei_scores.launches_by.values()) == 0
    assert fleet.dispatches == d0


@pytest.mark.cuda
def test_columns_feed_the_ring_on_the_card(tmp_path):
    srv = ServiceServer(str(tmp_path / "wal"), fsync="never")
    srv.start()
    try:
        dom, docs = _history(60, 3, "e0")
        nt = NetTrials(srv.url, exp_key="e0", timeout=TIMEOUT)
        nt.save_domain(dom)
        nt.insert_trial_docs(docs[:40])
        ft = srv._store("e0")
        nt.suggest(1, new_ids=[1000], insert=False)
        p = dom.cs.n_params
        for lo, hi in ((40, 41), (41, 46)):
            nt.insert_trial_docs(docs[lo:hi])
            up0 = history.upload_bytes
            nt.suggest(2, new_ids=[1000], insert=False)
            assert history.upload_bytes - up0 \
                == (hi - lo) * history._row_bytes(p)
        cap0 = len(ft._col["tids"])
        more = rand.suggest(list(range(60, 60 + cap0)), dom,
                            ht.Trials(), 5)
        for d in more:
            d.update(state=base.JOB_STATE_DONE, exp_key="e0",
                     result={"status": "ok", "loss": 0.5})
        nt.insert_trial_docs(docs[46:] + json.loads(json.dumps(more)))
        got = nt.suggest(3, new_ids=[5000], insert=False)
        assert len(ft._col["tids"]) > cap0          # the columns regrew
        local = base.trials_from_docs(
            json.loads(json.dumps(docs + json.loads(json.dumps(more)))),
            exp_key="e0")
        want = tpe.suggest([5000], dom, local, 3, verbose=False)
        assert got == json.loads(json.dumps(want))
        cs = srv._domain_for(ft).cs
        h = ft.history(cs)
        st = next(v for (cid, _), v in history._STORE[ft].items()
                  if cid == id(cs))
        torch.cuda.synchronize()
        for buf, ref in zip(st.bufs, history._padded_history(h, st.cap)):
            assert np.array_equal(buf.cpu().numpy(), ref, equal_nan=True)
    finally:
        srv.shutdown()
