"""The PyTorch port's network store against hyperopt_tpu's.

* **Interop both ways**: a port ``NetTrials``/``NetWorker`` drives and
  drains a JAX ``StoreServer``, and a JAX ``NetTrials``/``NetWorker`` a
  port ``StoreServer``, in ``json`` and ``binary`` wire mode, with the
  same docs, claims and results as a port client on a port server (store
  verbs only: a domain pickled by one package is not the other's, so the
  workers are handed theirs).
* **Server-side against client-side suggest**: for every head of
  ``backends.names()``, ``server_suggest`` over ``NetTrials`` gives the
  docs of the in-process call on the same history and seed, bit for bit,
  in both wire modes (on the CPU: the published domain's device).
* **Mirrors** on the port of ``tests/test_parallel.py::TestNetStore``,
  ``test_faults.py::TestNetstoreHardening``,
  ``test_service.py::TestIdemCacheBounds`` and ``TestTenancy``'s server
  cases, ``test_lock_regressions.py::
  test_netstore_concurrent_idem_duplicates_execute_once``,
  ``test_obs.py::TestMetricsEndpoint``,
  ``test_obs_health.py::TestServerObservability``,
  ``test_obs_flight.py::TestBundleVerb`` and ``test_obs_fleet.py::
  TestHeartbeatLostUpdate`` and ``TestFleetMetrics``.  The JAX
  environment switches are the port's arguments here.

Every server binds port 0 and is shut down by a fixture; every client
and join has a timeout of its own.
"""

import hmac
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import (JOB_STATE_DONE, JOB_STATE_NEW, JOB_STATE_RUNNING,
                                backends, base, faults, hp, rand, wire)
from hyperopt_tpu_torch.backends import contract
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.exceptions import (NetstoreUnavailable,
                                           QuotaExceeded, is_transient)
from hyperopt_tpu_torch.obs import context as obs_context
from hyperopt_tpu_torch.obs import export, metrics
from hyperopt_tpu_torch.obs.events import EVENTS, EventLog
from hyperopt_tpu_torch.obs.slo import SloMonitor, SloSpec, default_slos
from hyperopt_tpu_torch.obs.timeseries import TimeSeriesStore
from hyperopt_tpu_torch.parallel import (FileTrials, NetTrials, NetWorker,
                                         StoreServer)
from hyperopt_tpu_torch.parallel import netstore
from hyperopt_tpu_torch.parallel.netstore import server_suggest
from hyperopt_tpu_torch.service import Tenant, TenantTable

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
T0 = 1_000_000.0
TIMEOUT = 20.0          # every client's socket timeout, every join's wait


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = metrics.metrics_enabled()
    metrics.set_enabled(True)
    faults.clear()
    netstore._JSON_ONLY_PEERS.clear()
    yield
    faults.clear()
    netstore._JSON_ONLY_PEERS.clear()
    wire.set_mode("auto")
    metrics.set_enabled(was)
    torch.set_num_threads(n)


@pytest.fixture
def serve(tmp_path):
    """``serve(sub="store", **kw)`` starts a port server on port 0 under
    ``tmp_path/sub``; every server started is shut down after the test."""
    servers = []

    def start(sub="store", **kw):
        srv = StoreServer(str(tmp_path / sub), **kw)
        srv.start()
        servers.append(srv)
        return srv

    yield start
    for srv in servers:
        srv.shutdown()


def _nt(url, **kw):
    kw.setdefault("timeout", TIMEOUT)
    return NetTrials(url, **kw)


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


def _quad_space():
    return {"x": hp.uniform("x", -5, 5)}


def _quad(d):
    return (d["x"] - 3.0) ** 2


def _domain(fn=_quad, space=None):
    dom = Domain(fn, space or _quad_space())
    dom.cs.device = CPU
    return dom


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
    doc["result"] = {"status": "ok", "loss": float(loss)}
    return doc


def _new_docs(trials, n):
    return rand.suggest(trials.new_trial_ids(n), _domain(), trials, 0)


def _bits(x):
    """``x`` with floats as f64 bit patterns: equality is bit equality."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    if isinstance(x, float):
        return ("f", struct.pack("<d", x))
    return (type(x).__name__, x)


# ---------------------------------------------------------------------------
# interop with the JAX package, both ways, both wire modes
# ---------------------------------------------------------------------------


def _jax():
    from hyperopt_tpu.parallel import netstore as jnet

    return jnet


def _scenario(nt):
    """One scripted run of the store verbs; returns what a caller sees:
    every reply, and the final docs without their wall-clock stamps."""
    seen = [nt.new_trial_ids(4)]
    nt.insert_trial_docs(_mk_docs(seen[0], "e1", [0.5, -1.25, 2.0, 3.5]))
    d0 = nt.reserve("w0")
    d1 = nt.reserve("w1")
    seen += [d0["tid"], d1["tid"], nt.heartbeat(d0, owner="w0"),
             nt.heartbeat(d1, owner="intruder")]
    seen.append(nt.write_result(_complete(d0, 0.25), owner="w0"))
    seen.append(nt.write_result(_complete(dict(d1), 9.0), owner="intruder"))
    seen.append(nt.requeue_stale(0.0))
    d2 = nt.reserve("w2")
    seen += [d2["tid"], nt.write_result(_complete(d2, 1.5), owner="w2")]
    nt.attachments["meta"] = {"k": [1, 2.5]}
    seen += [sorted(nt.attachments), nt.attachments["meta"]]
    nt.refresh()
    docs = [{k: v for k, v in d.items()
             if k not in ("book_time", "refresh_time")}
            for d in nt._dynamic_trials]
    return _bits([seen, docs])


def _drain(server_url, client_pkg):
    """Enqueue 12 docs and drain them with two workers, all of
    ``client_pkg``; returns the (tid, x, loss) of every doc."""
    if client_pkg == "port":
        nt = _nt(server_url, exp_key="drain")
        dom = _domain()
        mk_worker = NetWorker
    else:
        jnet = _jax()
        from hyperopt_tpu import hp as jhp
        from hyperopt_tpu.base import Domain as JDomain

        nt = jnet.NetTrials(server_url, exp_key="drain", timeout=TIMEOUT)
        dom = JDomain(_quad, {"x": jhp.uniform("x", -5, 5)})
        mk_worker = jnet.NetWorker
    ids = nt.new_trial_ids(12)
    nt.insert_trial_docs(_mk_docs(ids, "drain", np.linspace(-4, 4, 12)))
    workers = [mk_worker(server_url, exp_key="drain", domain=dom,
                         poll_interval=0.01, reserve_timeout=0.5)
               for _ in range(2)]
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    _join(threads)
    nt.refresh()
    return [(d["tid"], d["state"], d["misc"]["vals"]["x"][0],
             d["result"].get("loss")) for d in nt._dynamic_trials]


@pytest.mark.parametrize("mode", ["json", "binary"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_interop_with_the_jax_package(tmp_path, monkeypatch, mode,
                                      server_pkg):
    """The other package's client on this server sees exactly what a port
    client on a port server sees, and its workers drain a queue there."""
    jnet = _jax()
    from hyperopt_tpu.obs import metrics as jmetrics

    monkeypatch.setenv("HYPEROPT_TPU_WIRE", mode)
    wire.set_mode(mode)
    ref_srv = StoreServer(str(tmp_path / "ref"))
    ref_srv.start()
    if server_pkg == "jax":
        srv = jnet.StoreServer(str(tmp_path / "other"))
        client = lambda url, **kw: _nt(url, **kw)          # noqa: E731
        client_pkg = "port"
    else:
        srv = StoreServer(str(tmp_path / "other"))
        client = lambda url, **kw: jnet.NetTrials(          # noqa: E731
            url, timeout=TIMEOUT, **kw)
        client_pkg = "jax"
    srv.start()
    try:
        frames0 = (_counter("wire.frames"),
                   jmetrics.registry().snapshot()["counters"].get(
                       "wire.frames", 0.0))
        want = _scenario(_nt(ref_srv.url, exp_key="e1"))
        got = _scenario(client(srv.url, exp_key="e1"))
        assert got == want
        rows = _drain(srv.url, client_pkg)
        assert [r[0] for r in rows] == list(range(12))
        for tid, state, x, loss in rows:
            assert state == JOB_STATE_DONE and loss == _quad({"x": x})
        frames = (_counter("wire.frames"),
                  jmetrics.registry().snapshot()["counters"].get(
                      "wire.frames", 0.0))
        if mode == "binary":
            assert frames[0] > frames0[0] and frames[1] > frames0[1]
        else:
            assert frames == frames0
    finally:
        srv.shutdown()
        ref_srv.shutdown()


def test_auto_mode_falls_back_to_json_on_a_refusing_peer(serve):
    """A binary frame sent to a server whose wire mode is ``json`` is
    refused; an ``auto`` client resends the same call as JSON once,
    pins the peer and counts the fallback."""
    srv = serve()
    nt = _nt(srv.url, exp_key="e", refresh=False)
    wire.set_mode("json")              # the server's mode, this process
    try:
        f0 = _counter("wire.json_fallbacks")
        # The client decides per call: force a frame as an auto client
        # would, with the server refusing it.
        with mock.patch.object(netstore._wire, "mode",
                               side_effect=["auto", "json", "json"]):
            tids = nt._rpc("insert_docs", docs=_mk_docs([0, 1], "e",
                                                        [0.1, 0.2]))["tids"]
        assert tids == [0, 1]
        assert _counter("wire.json_fallbacks") == f0 + 1
        assert srv.url in netstore._JSON_ONLY_PEERS
    finally:
        wire.set_mode("auto")


# ---------------------------------------------------------------------------
# server-side suggest against the in-process call, every head
# ---------------------------------------------------------------------------


def _suggest_space():
    return {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -4, 0),
            "q": hp.quniform("q", 0, 10, 1),
            "c": hp.choice("c", [0, 1, 2])}


def _suggest_objective(cfg):
    return (cfg["x"] - 1.0) ** 2 + cfg["lr"] + 0.1 * cfg["q"] + cfg["c"]


@pytest.fixture(scope="module")
def suggest_server(tmp_path_factory):
    from hyperopt_tpu_torch import atpe

    prev = atpe.set_transfer_store(None)
    srv = StoreServer(str(tmp_path_factory.mktemp("suggest")))
    srv.start()
    dom = _domain(_suggest_objective, _suggest_space())
    history = rand.suggest(list(range(30)), dom, ht.Trials(), 11)
    rng = np.random.default_rng(4)
    for d in history:
        d["state"] = JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    yield srv, dom, history
    srv.shutdown()
    atpe.set_transfer_store(prev)


@pytest.mark.parametrize("mode", ["json", "binary"])
@pytest.mark.parametrize("name", backends.names())
def test_server_suggest_equals_the_in_process_call(suggest_server, name,
                                                   mode):
    srv, dom, history = suggest_server
    wire.set_mode(mode)
    ek = f"{name}-{mode}"
    nt = _nt(srv.url, exp_key=ek)
    nt.save_domain(dom)
    nt.insert_trial_docs([dict(d, exp_key=ek) for d in history])
    nt.refresh()
    ids = [30, 31]
    got = server_suggest(ids, None, nt, 7, algo=name)
    local = base.trials_from_docs(
        [dict(d, exp_key=ek) for d in history], exp_key=ek)
    want = contract.server_table()[name](ids, dom, local, 7)
    assert _bits(got) == _bits(json.loads(json.dumps(want)))
    # Proposal only: the server inserted nothing.
    nt.refresh()
    assert len(nt) == len(history)


def test_server_suggest_inserts_on_request_and_refuses_unknowns(serve):
    srv = serve()
    nt = _nt(srv.url, exp_key="e")
    nt.save_domain(_domain())
    docs = nt.suggest(3, n=4, algo="rand")
    assert [d["tid"] for d in docs] == [0, 1, 2, 3]
    nt.refresh()
    assert len(nt) == 4 and all(d["state"] == JOB_STATE_NEW for d in nt)
    with pytest.raises(RuntimeError, match="UnknownBackend"):
        nt.suggest(3, n=1, algo="no_such_head")
    with pytest.raises(RuntimeError, match="unknown argument"):
        nt.suggest(3, n=1, algo="rand", bogus=1)
    with pytest.raises(TypeError):
        server_suggest([9], None, ht.Trials(), 1)


def test_a_head_registered_later_is_served_by_name(serve):
    """A head registered after the server's first suggest is servable
    (the way K2/K3 lowerings are served: a named head)."""
    from functools import partial

    from hyperopt_tpu_torch import tpe

    srv = serve()
    nt = _nt(srv.url, exp_key="e")
    dom = _domain()
    nt.save_domain(dom)
    docs = rand.suggest(nt.new_trial_ids(25), dom, nt, 0)
    for d in docs:
        _complete(d, _quad({"x": d["misc"]["vals"]["x"][0]}))
    nt.insert_trial_docs(docs)
    nt.suggest(1, new_ids=[99], algo="rand", insert=False)
    name = "tpe_bf16_test"
    backends.register_backend(name, partial(tpe.suggest,
                                            ei_precision="bf16"))
    try:
        nt.refresh()
        got = server_suggest([25], None, nt, 5, algo=name)
        local = base.trials_from_docs(docs, exp_key="e")
        want = tpe.suggest([25], dom, local, 5, ei_precision="bf16")
        assert _bits(got) == _bits(want)
    finally:
        with contract._REGISTRY_LOCK:
            contract._REGISTRY.pop(name, None)


def test_a_cuda_domain_on_a_server_without_a_card_raises(serve,
                                                         monkeypatch):
    """A domain published with no device resolves to CUDA on the
    server: without a card the suggest raises, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = serve()
    nt = _nt(srv.url, exp_key="e")
    dom = Domain(_quad, _quad_space())
    # No device: CUDA.  (Compiled spaces are shared by structure, so the
    # attribute is set here, and restored after.)
    monkeypatch.setattr(dom.cs, "device", None)
    nt.save_domain(dom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.suggest(1, n=1, algo="rand")
    nt.refresh()
    assert len(nt) == 0


def test_fmin_over_nettrials_with_server_suggest(serve):
    """``fmin(algo=server_suggest)`` publishes the domain on fmin's device
    and asks the server for every proposal; a worker evaluates them."""
    srv = serve()
    nt = _nt(srv.url, exp_key="e")
    w = NetWorker(srv.url, exp_key="e", domain=_domain(),
                  poll_interval=0.005, reserve_timeout=3.0)
    t = threading.Thread(target=w.run)
    s0 = _counter("netstore.verb.suggest.calls")
    t.start()
    try:
        ht.fmin(_quad, _quad_space(), algo=server_suggest, max_evals=24,
                trials=nt, rstate=np.random.default_rng(0), device=CPU,
                show_progressbar=False)
    finally:
        _join([t])
    nt.refresh()
    assert nt.load_domain().cs.device == CPU
    assert len(nt) == 24 and all(d["state"] == JOB_STATE_DONE for d in nt)
    assert _counter("netstore.verb.suggest.calls") - s0 == 24
    assert {d["owner"] for d in nt} == {w.owner}


# ---------------------------------------------------------------------------
# tests/test_parallel.py::TestNetStore
# ---------------------------------------------------------------------------


class TestNetStore:
    def test_net_workers_drain_queue(self, serve):
        srv = serve()
        dom = _domain()
        nt = _nt(srv.url, exp_key="e1")
        workers = [NetWorker(srv.url, exp_key="e1", domain=dom,
                             poll_interval=0.01, reserve_timeout=5)
                   for _ in range(3)]
        threads = [threading.Thread(target=w.run) for w in workers]
        for th in threads:
            th.start()
        try:
            ht.fmin(_quad, _quad_space(), algo=rand.suggest, max_evals=24,
                    trials=nt, rstate=np.random.default_rng(0), device=CPU,
                    show_progressbar=False)
        finally:
            _join(threads)
        nt.refresh()
        assert len(nt) == 24
        assert all(d["state"] == JOB_STATE_DONE for d in nt)
        assert all(d["owner"] for d in nt)
        assert nt.best_trial["result"]["loss"] < 30.0

    def test_net_exactly_once_over_sockets(self, serve):
        srv = serve()
        dom = _domain()
        nt = _nt(srv.url, exp_key="e1")
        nt.insert_trial_docs(rand.suggest(nt.new_trial_ids(10), dom, nt, 0))
        counts = {}
        lock = threading.Lock()

        class CountingWorker(NetWorker):
            def run_one(self):
                doc = self.trials.reserve(self.owner)
                if doc is None:
                    return False
                with lock:
                    counts[doc["tid"]] = counts.get(doc["tid"], 0) + 1
                doc["state"] = JOB_STATE_DONE
                doc["result"] = {"status": "ok", "loss": 1.0}
                self.trials.write_result(doc, owner=self.owner)
                return True

        ws = [CountingWorker(srv.url, exp_key="e1", domain=dom,
                             poll_interval=0.005, reserve_timeout=1)
              for _ in range(6)]
        threads = [threading.Thread(target=w.run) for w in ws]
        for th in threads:
            th.start()
        _join(threads)
        assert sorted(counts) == list(range(10))
        assert all(c == 1 for c in counts.values()), counts

    def test_net_owner_fencing_rejects_late_write(self, serve):
        srv = serve()
        dom = _domain()
        nt = _nt(srv.url, exp_key="e1")
        nt.insert_trial_docs(rand.suggest(nt.new_trial_ids(1), dom, nt, 0))
        doc_a = nt.reserve("worker-a")
        assert doc_a is not None
        assert nt.requeue_stale(0.0) == 1
        doc_b = nt.reserve("worker-b")
        assert doc_b is not None and doc_b["tid"] == doc_a["tid"]
        doc_a["state"] = JOB_STATE_DONE
        doc_a["result"] = {"status": "ok", "loss": 0.0}
        assert nt.write_result(doc_a, owner="worker-a") is False
        assert nt.heartbeat(doc_a, owner="worker-a") is False
        assert nt.write_result(doc_b, owner="worker-b") is True

    def test_net_auth_rejects_unauthenticated_peer(self, serve):
        srv = serve(token="s3kr1t")
        dom = _domain()
        good = _nt(srv.url, exp_key="e1", token="s3kr1t")
        docs = rand.suggest(good.new_trial_ids(1), dom, good, 0)
        good.insert_trial_docs(docs)
        for bad in (_nt(srv.url, exp_key="e1", refresh=False),
                    _nt(srv.url, exp_key="e1", refresh=False,
                        token="wrong")):
            with pytest.raises(RuntimeError, match="AuthError"):
                bad.reserve("intruder")
            with pytest.raises(RuntimeError, match="AuthError"):
                bad.insert_trial_docs(rand.suggest([99], dom, good, 1))
            with pytest.raises(RuntimeError, match="AuthError"):
                bad.refresh()
            fake = dict(docs[0], state=JOB_STATE_DONE,
                        result={"status": "ok", "loss": 0.0})
            with pytest.raises(RuntimeError, match="AuthError"):
                bad.write_result(fake, owner="intruder")
        good.refresh()
        assert len(good.trials) == 1
        doc = good.reserve("worker-a")
        assert doc is not None and doc["tid"] == docs[0]["tid"]
        _complete(doc, 1.0)
        assert good.write_result(doc, owner="worker-a") is True

    def test_net_server_restart_preserves_state(self, serve):
        srv = serve()
        dom = _domain()
        nt = _nt(srv.url, exp_key="e1")
        nt.save_domain(dom)
        nt.attachments["meta"] = {"tag": 7}
        nt.insert_trial_docs(rand.suggest(nt.new_trial_ids(6), dom, nt, 0))
        w = NetWorker(srv.url, exp_key="e1", domain=dom,
                      poll_interval=0.01, reserve_timeout=0.2)
        for _ in range(3):
            assert w.run_one() is True
        srv.shutdown()

        srv2 = serve()                      # same root, fresh port
        nt2 = _nt(srv2.url, exp_key="e1")
        assert len(nt2) == 6
        assert len([d for d in nt2 if d["state"] == JOB_STATE_DONE]) == 3
        assert nt2.attachments["meta"] == {"tag": 7}
        assert nt2.load_domain().cs.n_params == dom.cs.n_params
        w2 = NetWorker(srv2.url, exp_key="e1", domain=dom,
                       poll_interval=0.01, reserve_timeout=0.2)
        w2.run()
        nt2.refresh()
        assert all(d["state"] == JOB_STATE_DONE for d in nt2)

    def test_net_domain_and_attachments(self, serve):
        srv = serve()
        nt = _nt(srv.url, exp_key="e1")
        dom = _domain()
        nt.save_domain(dom)
        assert nt.load_domain().cs.n_params == dom.cs.n_params
        nt.attachments["blob"] = {"x": np.arange(3)}
        assert list(nt.attachments) == ["blob"]
        np.testing.assert_array_equal(nt.attachments["blob"]["x"],
                                      np.arange(3))
        del nt.attachments["blob"]
        assert "blob" not in list(nt.attachments)
        with pytest.raises(KeyError):
            del nt.attachments["blob"]

    def test_net_cli_server_and_worker_subprocesses(self, tmp_path):
        """A ``--serve`` process and a ``--worker`` process against it;
        the worker's fault schedule (two lost replies) is absorbed by its
        retries and the server's idempotency cache."""
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        root = str(tmp_path / "store")
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        server = subprocess.Popen(
            [sys.executable, "-m", "hyperopt_tpu_torch.parallel.netstore",
             "--serve", "--root", root, "--port", str(port),
             "--token", "tok"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            url = f"http://127.0.0.1:{port}"
            nt = None
            for _ in range(200):
                try:
                    nt = _nt(url, exp_key="e1", token="tok", retries=0)
                    break
                except NetstoreUnavailable:
                    time.sleep(0.1)
            assert nt is not None, "server never came up"
            # By value: the worker process cannot import this module.
            dom = _domain(lambda d: (d["x"] - 3.0) ** 2)
            nt.save_domain(dom)
            nt.insert_trial_docs(rand.suggest(nt.new_trial_ids(8), dom,
                                              nt, 0))
            worker = subprocess.run(
                [sys.executable, "-m",
                 "hyperopt_tpu_torch.parallel.netstore", "--worker", url,
                 "--exp-key", "e1", "--token", "tok",
                 "--reserve-timeout", "2", "--poll-interval", "0.01",
                 "--faults", "rpc.recv=1.0:2"],
                env=env, cwd=ROOT, capture_output=True, text=True,
                timeout=120)
            assert worker.returncode == 0, worker.stderr[-2000:]
            nt.refresh()
            assert len(nt) == 8
            assert all(d["state"] == JOB_STATE_DONE for d in nt)
        finally:
            server.terminate()
            out, _ = server.communicate(timeout=20)
        assert server.returncode == 0 and "shut down" in out


# ---------------------------------------------------------------------------
# tests/test_faults.py::TestNetstoreHardening
# ---------------------------------------------------------------------------


class TestNetstoreHardening:
    def test_recv_fault_replays_idempotently(self, serve):
        srv = serve()
        nt = _nt(srv.url, exp_key="e1", retries=8, backoff=0.005)
        hits0 = _counter("netstore.idem.hits")
        faults.configure({"rpc.recv": {"prob": 1.0, "times": 3}}, seed=0)
        ids = nt.new_trial_ids(3)
        nt.insert_trial_docs(rand.suggest(ids, _domain(), nt, 0))
        faults.clear()
        assert ids == [0, 1, 2]
        nt.refresh()
        assert sorted(d["tid"] for d in nt) == [0, 1, 2]
        assert _counter("netstore.idem.hits") >= hits0 + 1
        assert nt.new_trial_ids(1) == [3]

    def test_send_faults_retry_transparently(self, serve):
        srv = serve()
        nt = _nt(srv.url, exp_key="e1", retries=8, backoff=0.005)
        r0 = _counter("netstore.rpc.retry")
        faults.configure({"rpc.send": {"prob": 1.0, "times": 4}}, seed=0)
        assert nt.new_trial_ids(2) == [0, 1]
        nt.refresh()
        faults.clear()
        assert _counter("netstore.rpc.retry") >= r0 + 4

    def test_dead_server_raises_typed_unavailable(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        nt = _nt(f"http://127.0.0.1:{port}", exp_key="e1", refresh=False,
                 retries=2, backoff=0.005)
        with pytest.raises(NetstoreUnavailable) as ei:
            nt.refresh()
        assert ei.value.attempts == 3
        assert is_transient(ei.value)

    def test_server_reported_errors_never_retried(self, serve):
        srv = serve(token="s3kr1t")
        r0 = _counter("netstore.rpc.retry")
        nt = _nt(srv.url, exp_key="e1", refresh=False, retries=5)
        with pytest.raises(RuntimeError, match="netstore server"):
            nt.refresh()
        assert _counter("netstore.rpc.retry") == r0

    def test_shutdown_idempotent_and_prestart_safe(self, tmp_path, serve):
        srv = StoreServer(str(tmp_path / "a"))
        t0 = time.monotonic()
        srv.shutdown()
        srv.shutdown()
        assert time.monotonic() - t0 < 2.0
        srv2 = serve("b")
        srv2.shutdown()
        srv2.shutdown()

    def test_janitor_requeues_stale_claims(self, serve):
        srv = serve(requeue_stale_every=0.1, stale_timeout=0.4)
        nt = _nt(srv.url, exp_key="e1")
        nt.insert_trial_docs(rand.suggest(nt.new_trial_ids(1), _domain(),
                                          nt, 0))
        doc = nt.reserve("ghost:1:dead")
        assert doc is not None and doc["tid"] == 0
        r0 = _counter("store.requeued")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            nt.refresh()
            if nt._dynamic_trials[0]["state"] == JOB_STATE_NEW:
                break
            time.sleep(0.05)
        assert nt._dynamic_trials[0]["state"] == JOB_STATE_NEW
        assert _counter("store.requeued") >= r0 + 1
        assert nt.reserve("live:2:beat")["tid"] == 0


# ---------------------------------------------------------------------------
# tests/test_service.py: TestIdemCacheBounds and TestTenancy's server cases
# ---------------------------------------------------------------------------


class TestIdemCacheBounds:
    @staticmethod
    def _dispatch(srv, idem, n=1):
        return srv._dispatch({"verb": "new_trial_ids", "n": n,
                              "exp_key": "e", "idem": idem})

    def test_lru_cap_evicts_and_counts(self, tmp_path):
        srv = StoreServer(str(tmp_path), idem_cap=3)
        try:
            before = _counter("netstore.idem.evicted")
            for k in range(5):
                self._dispatch(srv, f"k{k}")
            assert len(srv._idem) == 3
            assert _counter("netstore.idem.evicted") - before == 2
            assert self._dispatch(srv, "k4") == self._dispatch(srv, "k4")
        finally:
            srv.shutdown()

    def test_ttl_expiry(self, tmp_path):
        srv = StoreServer(str(tmp_path), idem_ttl_s=0.02)
        try:
            out1 = self._dispatch(srv, "t1")
            before = _counter("netstore.idem.evicted")
            time.sleep(0.05)
            out2 = self._dispatch(srv, "t1")
            assert out2["tids"] != out1["tids"]
            assert _counter("netstore.idem.evicted") - before >= 1
        finally:
            srv.shutdown()

    def test_single_token_auth_uses_compare_digest(self, serve):
        srv = serve(token="s3cret")
        with mock.patch("hmac.compare_digest",
                        wraps=hmac.compare_digest) as spy:
            nt = _nt(srv.url, exp_key="e", token="s3cret", refresh=False)
            nt.refresh()
            assert spy.call_count >= 1
            bad = _nt(srv.url, exp_key="e", token="nope", refresh=False)
            with pytest.raises(RuntimeError, match="AuthError"):
                bad.refresh()


class TestTenancy:
    def test_tenant_isolation_and_auth(self, serve):
        tt = TenantTable([Tenant("acme", "tok-a"), Tenant("bob", "tok-b")])
        srv = serve(tenants=tt)
        na = _nt(srv.url, exp_key="e1", token="tok-a")
        nb = _nt(srv.url, exp_key="e1", token="tok-b")
        na._insert_trial_docs(_mk_docs([0, 1], "e1", [0.1, 0.2]))
        na.refresh(), nb.refresh()
        assert len(na._dynamic_trials) == 2
        assert len(nb._dynamic_trials) == 0
        nb._insert_trial_docs(_mk_docs([0], "e1", [0.9]))
        na.refresh(), nb.refresh()
        assert len(na._dynamic_trials) == 2
        assert len(nb._dynamic_trials) == 1
        bad = _nt(srv.url, exp_key="e1", token="wrong", refresh=False)
        with pytest.raises(RuntimeError, match="AuthError"):
            bad.refresh()

    def test_max_claims_quota(self, serve):
        tt = TenantTable([Tenant("acme", "tok-a", max_claims=1)])
        srv = serve(tenants=tt)
        nt = _nt(srv.url, exp_key="e1", token="tok-a")
        nt._insert_trial_docs(_mk_docs([0, 1], "e1", [0.1, 0.2]))
        doc = nt.reserve("w0")
        assert doc is not None
        assert nt.reserve("w1") is None
        assert _counter("netstore.tenant.acme.quota.claims_rejected") >= 1
        assert nt.write_result(_complete(doc, 1.0), owner="w0")
        assert nt.reserve("w1")["tid"] == 1

    def test_trials_per_s_quota_is_typed_and_not_retried(self, serve):
        tt = TenantTable([Tenant("acme", "tok-a", trials_per_s=0.001,
                                 burst=2)])
        srv = serve(tenants=tt)
        nt = _nt(srv.url, exp_key="e1", token="tok-a")
        nt._insert_trial_docs(_mk_docs([0, 1], "e1", [0.1, 0.2]))
        before = _counter("netstore.rpc.retry")
        with pytest.raises(QuotaExceeded):
            nt._insert_trial_docs(_mk_docs([2], "e1", [0.3]))
        assert _counter("netstore.rpc.retry") == before
        nt.refresh()
        assert len(nt._dynamic_trials) == 2


def test_netstore_concurrent_idem_duplicates_execute_once(tmp_path):
    """``tests/test_lock_regressions.py``: concurrent duplicate retries of
    one idempotency key execute the verb once."""
    server = StoreServer(str(tmp_path))
    try:
        calls = []
        entered = threading.Event()
        release = threading.Event()

        def fake_verb(verb, req, tenant=None, idem=None):
            calls.append(verb)
            entered.set()
            release.wait(5.0)
            return {"ok": True, "serial": len(calls)}

        server._dispatch_verb = fake_verb
        results = []

        def call():
            results.append(server._dispatch(
                {"verb": "insert", "exp_key": "e", "idem": "k1"}))

        t1 = threading.Thread(target=call)
        t1.start()
        assert entered.wait(5.0)
        t2 = threading.Thread(target=call)
        t2.start()
        time.sleep(0.05)
        release.set()
        _join([t1, t2])
        assert calls == ["insert"]
        assert results[0] == results[1] == {"ok": True, "serial": 1}
        assert server._idem_inflight == {}
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# observability over the wire: test_obs.py, test_obs_health.py,
# test_obs_flight.py, test_obs_fleet.py
# ---------------------------------------------------------------------------


def _get(url, token=None, accept=None):
    headers = {}
    if token:
        headers["X-Netstore-Token"] = token
    if accept:
        headers["Accept"] = accept
    return urlopen(Request(url, headers=headers), timeout=TIMEOUT)


def test_metrics_get_requires_token(serve):
    """``test_obs.py::TestMetricsEndpoint``."""
    srv = serve(token="s3kr1t")
    for bad in (None, "wrong"):
        with pytest.raises(HTTPError) as ei:
            _get(srv.url + "/metrics", token=bad)
        assert ei.value.code == 401
    with _get(srv.url + "/metrics", token="s3kr1t") as resp:
        snap = json.loads(resp.read())
    assert {"enabled", "counters", "gauges", "kernel_cache",
            "histograms"} <= set(snap)
    with pytest.raises(HTTPError) as ei:
        _get(srv.url + "/not-metrics", token="s3kr1t")
    assert ei.value.code == 404
    nt = _nt(srv.url, exp_key="e1", token="s3kr1t", refresh=False)
    assert "kernel_cache" in nt.metrics()
    with pytest.raises(RuntimeError, match="AuthError"):
        _nt(srv.url, exp_key="e1", refresh=False).metrics()


def _seed_completed(nt, dom, losses):
    docs = rand.suggest(nt.new_trial_ids(len(losses)), dom, nt, 0)
    for d, loss in zip(docs, losses):
        _complete(d, loss)
    nt.insert_trial_docs(docs)


class TestServerObservability:
    def test_negotiation_and_health_verb(self, serve):
        srv = serve(token="s3kr1t")
        nt = _nt(srv.url, exp_key="e1", token="s3kr1t")
        _seed_completed(nt, _domain(),
                        [5.0 - 0.5 * i for i in range(8)] + [1.0] * 22)
        rep = nt.health()
        assert rep["e1"]["verdict"] == "stagnating"
        assert rep["e1"]["n_done"] == 30
        assert nt.health(all=True, introspect=False)["e1"][
            "introspection"] is None
        status = srv.observe_pass(now=T0)
        assert [s["name"] for s in status] == \
            [s.name for s in default_slos()]
        with _get(srv.url + "/metrics", token="s3kr1t") as resp:
            assert "json" in resp.headers["Content-Type"]
            snap = json.loads(resp.read())
        assert {"enabled", "counters", "gauges", "histograms", "fleet",
                "health", "alerts"} <= set(snap)
        assert snap["health"]["e1"]["verdict"] == "stagnating"
        with _get(srv.url + "/metrics", token="s3kr1t",
                  accept="application/openmetrics-text") as resp:
            assert resp.headers["Content-Type"] == export.CONTENT_TYPE
            fams = export.parse_openmetrics(resp.read().decode("utf-8"))
        assert [f for f in fams if "health_verdict" in f], sorted(fams)

    def test_health_introspects_the_served_head_under_the_device_lock(
            self, serve, monkeypatch):
        """After a server-side TPE suggest, the ``health`` verb runs the
        head's introspection fit, holding the server's device lock."""
        from hyperopt_tpu_torch.obs import health

        srv = serve()
        nt = _nt(srv.url, exp_key="e1")
        dom = _domain()
        nt.save_domain(dom)
        _seed_completed(nt, dom, [float(i % 7) for i in range(30)])
        nt.suggest(3, n=1, algo="tpe")
        held = []
        real = health.assess

        def spy(*a, **kw):
            held.append(srv.device_lock._is_owned())
            return real(*a, **kw)

        monkeypatch.setattr(netstore._obs_health, "assess", spy)
        rep = nt.health()["e1"]
        assert rep["algo"] == "tpe" and rep["introspection"] is not None
        assert "error" not in rep["introspection"]
        assert held == [True]

    def test_rpc_fault_chaos_fires_alert(self, serve):
        srv = serve()
        log = EventLog()
        log.enable()
        nt = _nt(srv.url, exp_key="e1", backoff=0.05)
        ts = TimeSeriesStore()
        spec = SloSpec("suggest_p95", metric="netstore.client.rpc.s",
                       kind="latency_p95", target=0.04, budget=0.5,
                       fast_window=10, slow_window=40)
        mon = SloMonitor((spec,), ts, events=log)
        nt.refresh()
        ts.scrape(now=T0 - 50)
        for i in range(3):
            with faults.injected("rpc.send", prob=1.0, times=2, seed=i):
                nt.refresh()
        ts.scrape(now=T0)
        (st,) = mon.evaluate(now=T0)
        assert st["burn_fast"] >= 1.0 and st["burn_slow"] >= 1.0
        assert st["firing"] is True
        for _ in range(3):
            nt.refresh()
        ts.scrape(now=T0 + 20)
        (st,) = mon.evaluate(now=T0 + 20)
        assert st["firing"] is False
        alerts = [e for e in log.snapshot() if e["type"] == "slo_alert"]
        assert [e["state"] for e in alerts] == ["firing", "resolved"]


def test_bundle_verb_pull(serve, tmp_path):
    """``test_obs_flight.py::TestBundleVerb``."""
    srv = serve(token="s3kr1t")
    nt = _nt(srv.url, exp_key="e1", token="s3kr1t")
    out_dir = str(tmp_path / "pulled")
    payload = nt.bundle(out_dir=out_dir)
    assert payload["manifest"]["reason"] == "verb"
    assert payload["manifest"]["extra"]["trigger"] == "verb"
    assert "series" in payload and "slo" in payload
    assert os.path.exists(os.path.join(out_dir, "loop_events.jsonl"))
    with pytest.raises(RuntimeError, match="AuthError"):
        _nt(srv.url, exp_key="e1", token="wrong").bundle()


class TestHeartbeatLostUpdate:
    @pytest.mark.parametrize("over", ["file", "net"])
    def test_stale_beat_cannot_clobber_result(self, serve, tmp_path, over):
        if over == "file":
            ft = FileTrials(str(tmp_path / "fs"), exp_key="e1")
        else:
            ft = _nt(serve().url, exp_key="e1")
        ft.insert_trial_docs(_new_docs(ft, 1))
        doc = ft.reserve("w:1")
        stale = dict(doc)
        _complete(doc, 1.25)
        assert ft.write_result(doc, owner="w:1")
        ft.heartbeat(stale, owner="w:1")
        ft.refresh()
        cur = ft.trials[0]
        assert cur["state"] == JOB_STATE_DONE
        assert cur["result"]["loss"] == 1.25

    @pytest.mark.parametrize("over", ["file", "net"])
    def test_beat_on_running_trial_still_stamps(self, serve, tmp_path,
                                                over):
        if over == "file":
            ft = FileTrials(str(tmp_path / "fs"), exp_key="e1")
        else:
            ft = _nt(serve().url, exp_key="e1")
        ft.insert_trial_docs(_new_docs(ft, 1))
        doc = ft.reserve("w:1")
        before = doc.get("refresh_time")
        time.sleep(0.01)
        assert ft.heartbeat(doc, owner="w:1")
        ft.refresh()
        cur = ft.trials[0]
        assert cur["state"] == JOB_STATE_RUNNING
        assert cur["refresh_time"] >= before


class TestFleetMetrics:
    def test_metrics_get_auth_and_fleet_key(self, serve):
        srv = serve(token="s3kr1t")
        with pytest.raises(HTTPError) as ei:
            _get(srv.url + "/metrics")
        assert ei.value.code == 401
        with _get(srv.url + "/metrics", token="s3kr1t") as resp:
            snap = json.loads(resp.read())
        assert {"enabled", "counters", "gauges", "histograms",
                "fleet"} <= set(snap)
        assert snap["fleet"]["n_workers"] == 0
        assert snap["fleet"]["workers"] == {}

    def test_heartbeat_piggyback_labels_and_reset_survival(self, serve):
        srv = serve()
        nt = _nt(srv.url, exp_key="e1")
        nt.metrics_push_interval = 0.0
        nt.insert_trial_docs(_new_docs(nt, 1))
        doc = nt.reserve("w1:1:abcd1234")
        assert doc is not None
        assert nt.heartbeat(doc, owner="w1:1:abcd1234") is True
        fleet = srv.metrics_payload()["fleet"]
        assert fleet["n_workers"] == 1
        w = fleet["workers"]["w1:1:abcd1234"]
        assert w["age_s"] < 30.0
        assert "counters" in w and "histograms" in w
        assert "counters" in fleet["merged"]
        metrics.registry().snapshot(reset=True)
        assert "w1:1:abcd1234" in srv.metrics_payload()["fleet"]["workers"]
        assert abs(metrics.registry().gauge("clock.skew_s").value) < 5.0

    def test_fleet_round_trips_through_nettrials_metrics(self, serve):
        srv = serve()
        nt = _nt(srv.url, exp_key="e1")
        nt.metrics_push_interval = 0.0
        nt.insert_trial_docs(_new_docs(nt, 1))
        doc = nt.reserve("w2:9:ffff0000")
        nt.heartbeat(doc, owner="w2:9:ffff0000")
        via_rpc = nt.metrics()
        assert via_rpc["fleet"]["n_workers"] == 1
        hist = via_rpc["fleet"]["merged"]["histograms"].get(
            "netstore.client.rpc.s")
        assert hist is not None and hist["count"] >= 1
        assert "state" in hist

    def test_rpc_bodies_carry_ctx_when_armed(self, serve):
        srv = serve()
        was = obs_context.armed()
        obs_context.enable()
        try:
            nt = _nt(srv.url, exp_key="e1")
            EVENTS.enable()
            with obs_context.bind(trace_id="feedface", tid=123):
                nt.refresh()
            rpcs = [e for e in EVENTS.snapshot() if e["type"] == "rpc"
                    and e.get("name") in ("docs", "fetch_since")]
            assert rpcs, "server emitted no rpc event"
            assert rpcs[-1]["trace_id"] == "feedface"
            assert rpcs[-1]["trial"] == 123
        finally:
            EVENTS.disable()
            EVENTS.clear()
            if not was:
                obs_context.disable()


def test_shed_directive_refuses_admission_with_typed_backpressure(serve):
    """A shed directive refuses the admission verbs with a retriable 503
    the client honors ``backpressure_retries`` times, then surfaces as
    ``Backpressure``; consumers keep running."""
    from hyperopt_tpu_torch.exceptions import Backpressure

    srv = serve()
    nt = _nt(srv.url, exp_key="e", backpressure_retries=1)
    nt.insert_trial_docs(_mk_docs([0], "e", [0.5]))
    assert nt._rpc("shed", level=1.0, ttl_s=30.0,
                   retry_after_s=0.01)["level"] == 1.0
    h0 = _counter("backpressure.client.honored")
    with pytest.raises(Backpressure):
        nt.new_trial_ids(1)
    assert _counter("backpressure.client.honored") == h0 + 1
    assert nt.reserve("w")["tid"] == 0
    nt._rpc("shed", level=0.0)
    assert nt.new_trial_ids(1) == [1]


def test_rpc_pool_size_is_a_setter(serve):
    srv = serve()
    prev = netstore.set_rpc_pool_size(0)
    try:
        nt = _nt(srv.url, exp_key="e", refresh=False)
        assert nt.new_trial_ids(1) == [0]
        assert netstore._rpc_pool().size == 0
        assert netstore._rpc_pool()._idle == {}
        with pytest.raises(ValueError):
            netstore.set_rpc_pool_size(-1)
    finally:
        netstore.set_rpc_pool_size(prev)
    assert netstore._rpc_pool().size == prev
