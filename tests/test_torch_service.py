"""The PyTorch port's suggestion service against hyperopt_tpu's.

* **Suggest parity**: a ``ServiceServer`` server-side suggest equals the
  in-process ``tpe.suggest`` on the same history and seed (the port's rows
  are held to JAX's by ``tests/test_torch_tpe.py``), on both arms of the
  wire and the store columns.
* **Cohort parity**: with three tenants in one ``cohort_window_ms``, the
  gate's rows equal their solo rows, with one ``fleet.dispatches``; a
  scheduler that raises sends the window down the solo path with equal
  rows and logs the failure.
* **The two locks**: a ``health`` verb with introspection (``device_lock``
  without ``_lock``) runs in a loop through cohort windows (``_lock``
  then ``device_lock``), with no deadlock and equal rows.
* **Recovery runs no head**: a ``ServiceServer`` recovering a log that
  holds server-side suggests rebuilds the live ``state_bytes()`` with
  every head made to raise.
* **Worker faults**: ``NetWorker(faults=)`` and the netstore CLI's
  ``--faults`` arm a worker's fault schedule, as ``FileWorker`` does.
* **Mirrors** on the port of ``tests/test_service.py::TestWalReplay``,
  ``TestServerSuggest`` and ``TestChaosKillReplay``,
  ``tests/test_wire.py::TestNegotiation`` and ``TestSuggestParity``,
  ``tests/test_service_hotpath.py::TestGroupCommitKillDurability`` and
  ``tests/test_fleet.py::TestServiceGate``'s two server cases.  The JAX
  environment switches are the port's arguments here (``wire.set_mode``,
  ``ServiceServer(columns=)``, the CLI's ``--wal-crash`` and
  ``--faults``); the chaos servers are child processes, SIGKILLed there.

Every server binds port 0 and is shut down by the test; every client,
join and child process has a timeout of its own.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import base, fleet, hp, rand, tpe, wire
from hyperopt_tpu_torch.backends import resolve
from hyperopt_tpu_torch.base import (JOB_STATE_DONE, JOB_STATE_NEW,
                                     JOB_STATE_RUNNING, STATUS_OK)
from hyperopt_tpu_torch.exceptions import NetstoreUnavailable, QuotaExceeded
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.parallel import netstore
from hyperopt_tpu_torch.parallel.netstore import NetTrials, server_suggest
from hyperopt_tpu_torch.service import Tenant, TenantTable
from hyperopt_tpu_torch.service import wal as wal_mod
from hyperopt_tpu_torch.service.server import ServiceServer

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = metrics.metrics_enabled()
    metrics.set_enabled(True)
    netstore._JSON_ONLY_PEERS.clear()
    yield
    netstore._JSON_ONLY_PEERS.clear()
    wire.set_mode("auto")
    metrics.set_enabled(was)
    torch.set_num_threads(n)


@pytest.fixture
def serve(tmp_path):
    """``serve(sub="wal", **kw)``: a port ``ServiceServer`` on port 0,
    shut down after the test."""
    servers = []

    def start(sub="wal", **kw):
        srv = ServiceServer(str(tmp_path / sub), **kw)
        srv.start()
        servers.append(srv)
        return srv

    yield start
    for srv in servers:
        srv.shutdown()


def _counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


def _nt(url, **kw):
    kw.setdefault("timeout", TIMEOUT)
    return NetTrials(url, **kw)


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _mk_docs(tids, exp_key, xs):
    docs = []
    for tid, x in zip(tids, xs):
        d = base.new_trial_doc(tid, exp_key, None)
        d["misc"]["idxs"] = {"x": [tid]}
        d["misc"]["vals"] = {"x": [float(x)]}
        docs.append(d)
    return docs


def _complete(doc, loss):
    doc["state"] = JOB_STATE_DONE
    doc["result"] = {"status": STATUS_OK, "loss": float(loss)}
    return doc


def _mk_domain():
    space = {"x": hp.uniform("x", -5, 5),
             "c": hp.choice("c", [0, 1, 2])}
    dom = base.Domain(lambda a: a["x"] ** 2, space)
    dom.cs.device = CPU
    return dom


def _gate_domain(labels=("x", "lr", "c", "a")):
    x, lr, c, a = labels
    space = {
        x: hp.uniform(x, -5, 5),
        lr: hp.loguniform(lr, -6, 0),
        c: hp.choice(c, [{a: hp.normal(a, 0, 1)}, {"k": 2}]),
    }
    dom = base.Domain(lambda d: d[x] ** 2, space)
    dom.cs.device = CPU
    return dom


def _run_exp(dom, n, seed0, trials):
    rng = np.random.default_rng(seed0)
    start = len(trials._dynamic_trials)
    for i in range(n):
        trials.insert_trial_docs(
            rand.suggest([start + i], dom, trials,
                         int(rng.integers(2 ** 31))))
        trials.refresh()
        d = trials._dynamic_trials[-1]
        d["state"] = JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    trials.refresh()
    return trials


def _tenants(srv, n, n_hist=22):
    """``n`` tenants' stores on ``srv``, each with its own seeded history
    and published domain; returns ``(domains, local trials, clients)``."""
    doms, locals_, nts = [], [], []
    for e in range(n):
        dom = _gate_domain()
        local = base.Trials(exp_key=f"e{e}")
        nt = _nt(srv.url, exp_key=f"e{e}", token="t")
        nt.save_domain(dom)
        _run_exp(dom, n_hist + e, 50 + e, local)
        nt._insert_trial_docs(
            json.loads(json.dumps(list(local._dynamic_trials))))
        doms.append(dom)
        locals_.append(local)
        nts.append(nt)
    return doms, locals_, nts


def _concurrent(nts, seeds, new_ids, **kw):
    out = [None] * len(nts)

    def call(e):
        out[e] = nts[e].suggest(seeds[e], new_ids=new_ids[e], insert=False,
                                **kw)

    ts = [threading.Thread(target=call, args=(e,)) for e in range(len(nts))]
    for th in ts:
        th.start()
    _join(ts)
    return out


def _launch_server(args):
    """``python -m hyperopt_tpu_torch.service.server --serve ARGS`` in a
    child process; returns ``(proc, url)``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperopt_tpu_torch.service.server",
         "--serve"] + args, cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "service: serving" in line:
            return proc, line.rsplit(" at ", 1)[1].strip()
        if proc.poll() is not None:
            pytest.fail(f"server died on startup: {proc.stdout.read()}")
    proc.kill()
    pytest.fail("server never printed its URL")


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)
    proc.stdout.close()


# ---------------------------------------------------------------------------
# mirrors: tests/test_service.py::TestServerSuggest
# ---------------------------------------------------------------------------


class TestServerSuggest:
    def test_bit_identical_to_client_tpe(self, serve):
        tt = TenantTable([Tenant("acme", "tok-a")])
        srv = serve(tenants=tt)
        nt = _nt(srv.url, exp_key="e1", token="tok-a")
        local = base.Trials(exp_key="e1")
        domain = _mk_domain()
        nt.save_domain(domain)
        rng = np.random.default_rng(7)
        tid0 = 0
        for _batch in range(3):
            seed = int(rng.integers(2 ** 31 - 1))
            new_ids = list(range(tid0, tid0 + 4))
            tid0 += 4
            client_docs = tpe.suggest(new_ids, domain, local, seed,
                                      n_startup_jobs=4, verbose=False)
            server_docs = nt.suggest(seed, new_ids=new_ids, insert=False,
                                     n_startup_jobs=4)
            assert json.loads(json.dumps(client_docs)) == server_docs
            done = [_complete(d, d["misc"]["vals"]["x"][0] ** 2)
                    for d in client_docs]
            local.insert_trial_docs(done)
            local.refresh()
            nt._insert_trial_docs(json.loads(json.dumps(done)))

    def test_fmin_algo_adapter_matches(self, serve):
        srv = serve(token="t")
        nt = _nt(srv.url, exp_key="e1", token="t")
        domain = _mk_domain()
        nt.save_domain(domain)
        local = base.Trials(exp_key="e1")
        docs_srv = server_suggest([0, 1], domain, nt, 1234)
        docs_cli = tpe.suggest([0, 1], domain, local, 1234, verbose=False)
        assert json.loads(json.dumps(docs_cli)) == docs_srv
        with pytest.raises(TypeError):
            server_suggest([0], domain, local, 1)   # needs NetTrials

    def test_enqueue_form_allocates_and_inserts(self, serve):
        srv = serve(token="t")
        nt = _nt(srv.url, exp_key="e1", token="t")
        nt.save_domain(_mk_domain())
        docs = nt.suggest(seed=3, n=4, algo="rand")
        assert [d["tid"] for d in docs] == [0, 1, 2, 3]
        nt.refresh()
        assert len(nt._dynamic_trials) == 4   # inserted server-side
        docs2 = nt.suggest(seed=4, n=2, algo="rand")
        assert [d["tid"] for d in docs2] == [4, 5]

    def test_bad_requests_are_refused(self, serve):
        srv = serve(token="t")
        nt = _nt(srv.url, exp_key="e1", token="t")
        nt.save_domain(_mk_domain())
        with pytest.raises(RuntimeError, match="unknown algo"):
            nt.suggest(seed=1, n=1, algo="gradient_descent")
        with pytest.raises(RuntimeError, match="unknown argument"):
            nt.suggest(seed=1, n=1, algo="rand", exploit_me=True)
        with pytest.raises(RuntimeError, match="no domain"):
            _nt(srv.url, exp_key="other", token="t").suggest(
                seed=1, n=1, algo="rand")

    def test_registry_backends_served_by_name(self, serve):
        srv = serve(token="t")
        nt = _nt(srv.url, exp_key="e1", token="t")
        domain = _mk_domain()
        nt.save_domain(domain)
        local = base.Trials(exp_key="e1")
        docs = resolve("rand")(list(range(12)), domain, local, 5)
        done = [_complete(d, d["misc"]["vals"]["x"][0] ** 2) for d in docs]
        local.insert_trial_docs(done)
        local.refresh()
        nt._insert_trial_docs(json.loads(json.dumps(done)))
        for name, kw in (("gp", {"n_EI_candidates": 32}),
                         ("es", {"popsize": 4})):
            cli = resolve(name)(list(range(12, 14)), domain, local, 99, **kw)
            saw = nt.suggest(99, new_ids=[12, 13], insert=False, algo=name,
                             **kw)
            assert json.loads(json.dumps(cli)) == saw, name


# ---------------------------------------------------------------------------
# mirrors: tests/test_service.py::TestWalReplay
# ---------------------------------------------------------------------------


class TestWalReplay:
    def _drive(self, srv, token="tok-a"):
        nt = _nt(srv.url, exp_key="e1", token=token)
        nt._insert_trial_docs(_mk_docs([0, 1, 2], "e1", [0.1, 0.2, 0.3]))
        doc = nt.reserve("w0")
        nt.write_result(_complete(doc, 7.0), owner="w0")
        nt.reserve("w1")        # left RUNNING: claims must survive replay
        return nt

    def test_replay_restores_store_byte_identically(self, tmp_path):
        tt = TenantTable([Tenant("acme", "tok-a"), Tenant("bob", "tok-b")])
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, tenants=tt)
        srv.start()
        self._drive(srv)
        _nt(srv.url, exp_key="e1", token="tok-b").refresh()
        state_a = srv.state_bytes()
        srv.shutdown()
        srv2 = ServiceServer(wal_dir, tenants=tt)
        try:
            assert srv2.state_bytes() == state_a
        finally:
            srv2.shutdown()

    def test_snapshot_compaction_then_tail_replay(self, tmp_path):
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        nt = self._drive(srv, token="t")
        srv.snapshot()
        doc = nt.reserve("w2")
        assert doc is not None
        nt.write_result(_complete(doc, 9.0), owner="w2")
        state_a = srv.state_bytes()
        srv.shutdown()
        info = wal_mod.inspect(wal_dir)
        assert info["snapshot"] is not None
        assert 0 < info["records"] <= 4   # only the post-snapshot tail
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            assert srv2.state_bytes() == state_a
        finally:
            srv2.shutdown()

    def test_auto_snapshot_every_n_appends(self, serve, tmp_path):
        srv = serve(token="t", snapshot_every=2)
        self._drive(srv, token="t")
        info = wal_mod.inspect(str(tmp_path / "wal"))
        assert info["snapshot"] is not None
        assert info["records"] <= 2      # log keeps compacting

    def test_torn_tail_is_dropped_not_fatal(self, tmp_path):
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        self._drive(srv, token="t")
        state_a = srv.state_bytes()
        srv.shutdown()
        with open(os.path.join(wal_dir, "wal.jsonl"), "a") as f:
            f.write('{"t": 1, "verb": "insert_docs", "re')   # crash mid-append
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            assert srv2.state_bytes() == state_a
        finally:
            srv2.shutdown()
        assert wal_mod.inspect(wal_dir)["torn_tail"] == 1

    def test_idem_cache_survives_crash(self, tmp_path):
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        try:
            docs = _mk_docs([0], "e1", [0.5])
            out1 = srv._dispatch({"verb": "insert_docs", "docs": docs,
                                  "exp_key": "e1", "idem": "abc"})
        finally:
            srv.shutdown()
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            out2 = srv2._dispatch({"verb": "insert_docs", "docs": docs,
                                   "exp_key": "e1", "idem": "abc"})
            assert out2 == out1                    # cached, not re-executed
            ft = srv2._store("e1", tenant=None)
            ft.refresh()
            assert len(ft._dynamic_trials) == 1    # no duplicate insert
        finally:
            srv2.shutdown()

    def test_suggest_idem_reply_reconstructed_after_crash(self, tmp_path):
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        try:
            _nt(srv.url, exp_key="e1", token="t").save_domain(_mk_domain())
            out1 = srv._dispatch({"verb": "suggest", "seed": 5, "n": 2,
                                  "algo": "rand", "exp_key": "e1",
                                  "idem": "xyz"})
        finally:
            srv.shutdown()
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            out2 = srv2._dispatch({"verb": "suggest", "seed": 5, "n": 2,
                                   "algo": "rand", "exp_key": "e1",
                                   "idem": "xyz"})
            assert out2 == out1
            ft = srv2._store("e1", tenant=None)
            ft.refresh()
            assert [d["tid"] for d in ft._dynamic_trials] == [0, 1]
        finally:
            srv2.shutdown()


class TestRecoveryRunsNoHead:
    def test_replay_of_server_side_suggests_never_calls_a_head(
            self, tmp_path, monkeypatch):
        """The log holds the suggests' physical outcome; recovery equals
        the live ``state_bytes()`` with every head (and the TPE dispatch
        under them) made to raise, and the domain blob is stored as bytes,
        never unpickled."""
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t", fsync="never")
        srv.start()
        try:
            doms, _, nts = _tenants(srv, 2)
            for e, nt in enumerate(nts):
                nt.suggest(77 + e, n=2)                 # server-side TPE
                nt.suggest(80 + e, n=1, algo="rand")
            live = srv.state_bytes()
        finally:
            srv.shutdown()

        def boom(*a, **k):
            raise AssertionError("recovery ran a head")

        monkeypatch.setattr(tpe, "_dispatch_with", boom)
        monkeypatch.setattr(ServiceServer, "_server_algos",
                            classmethod(lambda cls: boom()))
        monkeypatch.setattr(ServiceServer, "_domain_for",
                            staticmethod(boom))
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            assert srv2.state_bytes() == live
        finally:
            srv2.shutdown()


# ---------------------------------------------------------------------------
# the cohort gate: parity, fallback, the two locks
# ---------------------------------------------------------------------------


class TestCohortGate:
    N = 3

    def test_concurrent_tenants_coalesce_with_parity(self, serve,
                                                     tmp_path):
        """Mirror of ``test_fleet.py::TestServiceGate::
        test_concurrent_tenants_coalesce_with_parity``."""
        srv = serve(token="t", fsync="never", cohort_window_ms=300)
        doms, locals_, nts = _tenants(srv, self.N)
        seeds = [4000 + 13 * e for e in range(self.N)]
        solo = [json.loads(json.dumps(
            tpe.suggest([22 + e], doms[e], locals_[e], seeds[e],
                        verbose=False)))
            for e in range(self.N)]
        d0 = fleet.dispatches
        out = _concurrent(nts, seeds, [[22 + e] for e in range(self.N)])
        assert out == solo
        assert fleet.dispatches == d0 + 1
        state1 = srv.state_bytes()
        srv.shutdown()
        srv2 = ServiceServer(str(tmp_path / "wal"), token="t")
        try:
            assert srv2.state_bytes() == state1
        finally:
            srv2.shutdown()

    def test_custom_kwargs_bypass_gate(self, serve):
        """Mirror of ``test_fleet.py::TestServiceGate::
        test_custom_kwargs_bypass_gate``."""
        srv = serve(token="t", fsync="never", cohort_window_ms=50)
        dom = _gate_domain()
        local = base.Trials(exp_key="e0")
        nt = _nt(srv.url, exp_key="e0", token="t")
        nt.save_domain(dom)
        _run_exp(dom, 24, 50, local)
        nt._insert_trial_docs(
            json.loads(json.dumps(list(local._dynamic_trials))))
        ref = json.loads(json.dumps(
            tpe.suggest([24], dom, local, 7, gamma=0.5, verbose=False)))
        d0 = fleet.dispatches
        out = nt.suggest(7, new_ids=[24], insert=False, gamma=0.5)
        assert out == ref
        assert fleet.dispatches == d0

    def test_equal_knobs_coalesce_and_other_knobs_go_solo(self, serve):
        """Members with equal TPE knobs (``n_EI_candidates=64``) share one
        cohort; a member with ``gamma=`` in the same window runs on its
        own; every row equals its solo row."""
        srv = serve(token="t", fsync="never", cohort_window_ms=300)
        doms, locals_, nts = _tenants(srv, self.N + 1)
        kws = [{"n_EI_candidates": 64}] * self.N \
            + [{"n_EI_candidates": 64, "gamma": 0.5}]
        seeds = [60 + e for e in range(self.N + 1)]
        solo = [json.loads(json.dumps(
            tpe.suggest([99], doms[e], locals_[e], seeds[e], verbose=False,
                        **kws[e])))
            for e in range(self.N + 1)]
        out = [None] * (self.N + 1)

        def call(e):
            out[e] = nts[e].suggest(seeds[e], new_ids=[99], insert=False,
                                    **kws[e])

        d0, s0 = fleet.dispatches, fleet.suggestions
        ts = [threading.Thread(target=call, args=(e,))
              for e in range(self.N + 1)]
        for th in ts:
            th.start()
        _join(ts)
        assert out == solo
        assert fleet.dispatches == d0 + 1
        assert fleet.suggestions == s0 + self.N

    def test_insert_form_windows_log_and_replay(self, serve, tmp_path):
        """Three windows of the enqueue form (the server allocates and
        inserts): one dispatch per window, the inserted docs equal the
        solo rows, and the WAL replays to the same bytes."""
        srv = serve(token="t", fsync="never", cohort_window_ms=300)
        doms, locals_, nts = _tenants(srv, self.N)
        d0 = fleet.dispatches
        for w in range(3):
            seeds = [900 + 10 * w + e for e in range(self.N)]
            solo = []
            for e in range(self.N):
                tid = locals_[e].new_trial_ids(1)
                docs = tpe.suggest(tid, doms[e], locals_[e], seeds[e],
                                   verbose=False)
                solo.append(json.loads(json.dumps(docs)))
                locals_[e].insert_trial_docs(docs)
                locals_[e].refresh()
            out = [None] * self.N

            def call(e):
                out[e] = nts[e].suggest(seeds[e], n=1)

            ts = [threading.Thread(target=call, args=(e,))
                  for e in range(self.N)]
            for th in ts:
                th.start()
            _join(ts)
            assert out == solo
            assert fleet.dispatches == d0 + w + 1
        state1 = srv.state_bytes()
        srv.shutdown()
        srv2 = ServiceServer(str(tmp_path / "wal"), token="t")
        try:
            assert srv2.state_bytes() == state1
        finally:
            srv2.shutdown()

    def test_failed_dispatch_falls_back_to_solo_and_logs(
            self, serve, monkeypatch, caplog):
        srv = serve(token="t", fsync="never", cohort_window_ms=300)
        doms, locals_, nts = _tenants(srv, self.N)
        seeds = [31 + e for e in range(self.N)]
        solo = [json.loads(json.dumps(
            tpe.suggest([22 + e], doms[e], locals_[e], seeds[e],
                        verbose=False)))
            for e in range(self.N)]

        def broken(self, requests):
            raise RuntimeError("scheduler made to raise")

        monkeypatch.setattr(fleet.CohortScheduler, "suggest_dispatch",
                            broken)
        d0 = fleet.dispatches
        with caplog.at_level(logging.ERROR,
                             logger="hyperopt_tpu_torch.service.server"):
            out = _concurrent(nts, seeds, [[22 + e] for e in range(self.N)])
        assert out == solo
        assert fleet.dispatches == d0
        assert any("cohort gate dispatch failed" in r.getMessage()
                   for r in caplog.records)

    def test_health_introspection_loops_through_cohort_windows(
            self, serve):
        """Lock order ``_lock`` → ``device_lock``: a ``health`` verb with
        introspection (``device_lock`` alone) in a loop while three
        windows run, with no deadlock and rows equal to the solo ones."""
        srv = serve(token="t", fsync="never", cohort_window_ms=300)
        doms, locals_, nts = _tenants(srv, self.N)
        for e, nt in enumerate(nts):          # gives health a head to fit
            nt.suggest(5 + e, new_ids=[500], insert=False)
        stop = threading.Event()
        seen = []
        errs = []

        def prober():
            probe = _nt(srv.url, exp_key="e0", token="t")
            while not stop.is_set():
                try:
                    rep = probe.health(all=True, introspect=True)
                    seen.append(len(rep))
                except Exception as e:      # surfaced after join
                    errs.append(e)
                    return

        th = threading.Thread(target=prober)
        th.start()
        try:
            d0 = fleet.dispatches
            for w in range(3):
                seeds = [700 + 10 * w + e for e in range(self.N)]
                solo = [json.loads(json.dumps(
                    tpe.suggest([600 + w], doms[e], locals_[e], seeds[e],
                                verbose=False)))
                    for e in range(self.N)]
                out = _concurrent(nts, seeds,
                                  [[600 + w]] * self.N)
                assert out == solo
            assert fleet.dispatches == d0 + 3
        finally:
            stop.set()
            _join([th])
        assert not errs
        assert seen


# ---------------------------------------------------------------------------
# mirrors: tests/test_wire.py::TestSuggestParity and TestNegotiation
# ---------------------------------------------------------------------------


class TestSuggestParity:
    def _drive_arm(self, tmp_path, tag, wire_mode, columns):
        wire.set_mode(wire_mode)
        srv = ServiceServer(str(tmp_path / f"wal-{tag}"), token="t",
                            columns=columns)
        srv.start()
        try:
            nt = _nt(srv.url, exp_key="e1", token="t")
            nt.save_domain(_mk_domain())
            rng = np.random.default_rng(7)
            batches, tid0 = [], 0
            for _ in range(3):
                seed = int(rng.integers(2 ** 31 - 1))
                new_ids = list(range(tid0, tid0 + 4))
                tid0 += 4
                docs = nt.suggest(seed, new_ids=new_ids, insert=False,
                                  n_startup_jobs=4)
                batches.append(docs)
                done = [_complete(d, d["misc"]["vals"]["x"][0] ** 2)
                        for d in json.loads(json.dumps(docs))]
                nt._insert_trial_docs(done)
            return batches
        finally:
            srv.shutdown()

    def test_binary_columnar_arm_matches_json_arm_bitwise(self, tmp_path):
        a = self._drive_arm(tmp_path, "json", "json", False)
        b = self._drive_arm(tmp_path, "bin", "binary", True)
        assert json.dumps(a, sort_keys=True) == json.dumps(
            b, sort_keys=True)


class TestNegotiation:
    def test_auto_client_downgrades_once_against_json_server(
            self, serve, monkeypatch):
        main = threading.get_ident()

        def split_mode():
            return "auto" if threading.get_ident() == main else "json"

        monkeypatch.setattr(wire, "mode", split_mode)
        srv = serve(token="t")
        fb0 = _counter("wire.json_fallbacks")
        nt = _nt(srv.url, exp_key="e1", token="t")
        nt._insert_trial_docs(_mk_docs([0, 1], "e1", [0.1, 0.2]))
        assert _counter("wire.json_fallbacks") - fb0 == 1
        assert nt._rpc.url in netstore._JSON_ONLY_PEERS
        nt.refresh()                      # framed verb, now JSON path
        assert [d["tid"] for d in nt._dynamic_trials] == [0, 1]
        assert _counter("wire.json_fallbacks") - fb0 == 1
        ft = srv._store("e1", tenant=None)
        ft.refresh()
        assert len(ft._dynamic_trials) == 2

    def test_quota_error_on_framed_verb_never_downgrades(self, serve):
        wire.set_mode("auto")
        tt = TenantTable([Tenant("acme", "tok-a", trials_per_s=0.001,
                                 burst=1)])
        srv = serve(tenants=tt)
        nt = _nt(srv.url, exp_key="e1", token="tok-a")
        nt._insert_trial_docs(_mk_docs([0], "e1", [0.1]))
        fb0 = _counter("wire.json_fallbacks")
        with pytest.raises(QuotaExceeded):
            nt._insert_trial_docs(_mk_docs([1], "e1", [0.2]))
        assert _counter("wire.json_fallbacks") == fb0
        assert nt._rpc.url not in netstore._JSON_ONLY_PEERS

    def test_binary_frames_actually_flow_and_are_counted(self, serve):
        wire.set_mode("binary")
        srv = serve(token="t")
        f0, tx0, rx0 = (_counter("wire.frames"), _counter("wire.bytes_tx"),
                        _counter("wire.bytes_rx"))
        nt = _nt(srv.url, exp_key="e1", token="t")
        nt._insert_trial_docs(_mk_docs([0, 1], "e1", [0.1, 0.2]))
        nt.refresh()
        assert _counter("wire.frames") > f0
        assert _counter("wire.bytes_tx") > tx0
        assert _counter("wire.bytes_rx") > rx0


# ---------------------------------------------------------------------------
# chaos: SIGKILL at the append / at the group-commit fsync (child processes)
# ---------------------------------------------------------------------------


def _kill_run(wal_dir, fault, extra=()):
    """A child server killed by ``fault``; returns the tids whose
    ``write_result`` was acked before the kill."""
    proc, url = _launch_server(["--wal-dir", wal_dir, "--token", "tok",
                                "--wal-crash", "kill", "--faults", fault]
                               + list(extra))
    try:
        nt = _nt(url, exp_key="e1", token="tok", retries=2, backoff=0.01,
                 refresh=False)
        tids = nt.new_trial_ids(4)
        assert tids == [0, 1, 2, 3]
        nt._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2, 0.3, 0.4]))
        crashed = False
        completed = []
        try:
            for _ in range(4):
                doc = nt.reserve("w0")
                assert nt.write_result(_complete(doc, 1.0), owner="w0")
                completed.append(doc["tid"])
        except NetstoreUnavailable:
            crashed = True
        assert crashed, "fault schedule never killed the server"
        assert proc.wait(timeout=20) == -signal.SIGKILL
    finally:
        _stop(proc)
    return completed


def _replay_and_finish(wal_dir, completed):
    srv = ServiceServer(wal_dir, token="tok")
    srv.start()
    try:
        nt = _nt(srv.url, exp_key="e1", token="tok")
        nt.refresh()
        seen = [d["tid"] for d in nt._dynamic_trials]
        assert sorted(seen) == [0, 1, 2, 3]          # zero lost
        assert len(seen) == len(set(seen))           # zero duplicated
        by_tid = {d["tid"]: d for d in nt._dynamic_trials}
        for t in completed:
            assert by_tid[t]["state"] == JOB_STATE_DONE
        for d in nt._dynamic_trials:
            if d["state"] == JOB_STATE_RUNNING:
                assert nt.write_result(_complete(dict(d), 1.0),
                                       owner=d["owner"])
        while True:
            doc = nt.reserve("w1")
            if doc is None:
                break
            assert nt.write_result(_complete(doc, 1.0), owner="w1")
        nt.refresh()
        assert all(d["state"] == JOB_STATE_DONE
                   for d in nt._dynamic_trials)
        assert not any(d["state"] == JOB_STATE_NEW
                       for d in nt._dynamic_trials)
    finally:
        srv.shutdown()


@pytest.mark.chaos
class TestChaosKillReplay:
    def test_sigkill_mid_write_result_zero_lost_or_duplicated(
            self, tmp_path):
        """A child server is SIGKILLed at the WAL append of a
        ``write_result`` (appends: 1 new_trial_ids, 2 insert_docs, then
        (reserve, write) pairs: the 8th append, ``@7``).  A fresh server
        on the same WAL dir replays with zero lost and zero duplicated
        tids, and the run completes."""
        wal_dir = str(tmp_path / "wal")
        completed = _kill_run(wal_dir, "wal.write=1.0:1@7")
        _replay_and_finish(wal_dir, completed)


@pytest.mark.chaos
class TestGroupCommitKillDurability:
    def test_sigkill_at_group_fsync_zero_lost_or_duplicated(self, tmp_path):
        """Killed at the group-commit ``wal.fsync`` of the third
        ``write_result`` (records flushed, no covering fsync, no waiter
        acked).  Replay loses no acked write and duplicates nothing."""
        wal_dir = str(tmp_path / "wal")
        completed = _kill_run(wal_dir, "wal.fsync=1.0:1@7",
                              extra=("--fsync", "always"))
        assert len(completed) == 2    # third ack cut at its fsync
        _replay_and_finish(wal_dir, completed)


# ---------------------------------------------------------------------------
# worker faults: NetWorker(faults=) and the netstore CLI's --faults
# ---------------------------------------------------------------------------


class TestWorkerFaults:
    def _enqueue(self, srv):
        nt = _nt(srv.url, exp_key="e1", token="t")
        dom = _mk_domain()
        nt.save_domain(dom)
        nt.suggest(seed=3, n=3, algo="rand")
        return nt

    def _one_retry(self, nt):
        nt.refresh()
        assert all(d["state"] == JOB_STATE_DONE for d in nt)
        assert sorted(d["misc"].get("fail_count", 0) for d in nt) \
            == [0, 0, 1]

    def test_networker_arms_its_fault_schedule(self, serve):
        """``NetWorker(faults=)`` arms the schedule for the worker's run:
        one injected ``worker.evaluate`` fault, retried once in place."""
        from hyperopt_tpu_torch import faults
        from hyperopt_tpu_torch.parallel import NetWorker

        srv = serve(token="t", fsync="never")
        nt = self._enqueue(srv)
        w = NetWorker(srv.url, exp_key="e1", token="t", poll_interval=0.01,
                      reserve_timeout=0.3, max_trial_retries=1,
                      faults="worker.evaluate=1.0:1", faults_seed=3)
        try:
            assert w.run() == 3
            assert faults.injection_counts()["worker.evaluate"] == {
                "calls": 4, "fired": 1}
        finally:
            faults.clear()
        self._one_retry(nt)

    def test_worker_cli_faults_flag(self, serve):
        """``python -m hyperopt_tpu_torch.parallel.netstore --worker URL
        --faults SPEC`` arms the same schedule in the worker process."""
        srv = serve(token="t", fsync="never")
        nt = self._enqueue(srv)
        proc = subprocess.run(
            [sys.executable, "-m", "hyperopt_tpu_torch.parallel.netstore",
             "--worker", srv.url, "--exp-key", "e1", "--token", "t",
             "--poll-interval", "0.01", "--reserve-timeout", "1",
             "--max-trial-retries", "1",
             "--faults", "worker.evaluate=1.0:1", "--faults-seed", "3"],
            cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        self._one_retry(nt)
