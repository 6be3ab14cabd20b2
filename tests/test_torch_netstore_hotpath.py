"""The PyTorch port's network store hot path: pooled RPC, long-poll
claims and read dispatch.

Mirrors ``tests/test_service_hotpath.py::TestPoolStaleReconnect``,
``TestPoolPoisonFlush``, ``TestLongPollClaims`` and
``TestReadDispatchUnderWriteStall`` on the port, with the JAX
environment switches as the port's arguments (``set_rpc_pool_size``,
``NetTrials(reserve_wait_s=)``, ``StoreServer(read_dispatch=)``).  Every
server binds port 0 (a restarted one rebinds its predecessor's) and is
shut down by a fixture; every client and join has a timeout of its own.
"""

import threading
import time

import pytest
import torch

from hyperopt_tpu_torch import base, faults
from hyperopt_tpu_torch.base import JOB_STATE_DONE, JOB_STATE_NEW, STATUS_OK
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.parallel import netstore
from hyperopt_tpu_torch.parallel.netstore import NetTrials, StoreServer
from hyperopt_tpu_torch.service import Tenant, TenantTable

TIMEOUT = 20.0


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = metrics.metrics_enabled()
    metrics.set_enabled(True)
    prev_pool = netstore.set_rpc_pool_size(8)
    faults.clear()
    yield
    faults.clear()
    netstore.set_rpc_pool_size(prev_pool)
    metrics.set_enabled(was)
    torch.set_num_threads(n)


@pytest.fixture
def servers():
    """A list the test appends its servers to; all are shut down after."""
    out = []
    yield out
    for srv in out:
        srv.shutdown()


def _start(servers, root, **kw):
    srv = StoreServer(root, **kw)
    srv.start()
    servers.append(srv)
    return srv


def _nt(url, **kw):
    kw.setdefault("timeout", TIMEOUT)
    kw.setdefault("refresh", False)
    return NetTrials(url, **kw)


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


def _wait_for(name, target, budget=5.0):
    deadline = time.monotonic() + budget
    while _counter(name) < target and time.monotonic() < deadline:
        time.sleep(0.01)
    return _counter(name)


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


class TestPoolStaleReconnect:
    def test_severed_keepalive_redials_without_burning_retries(
            self, tmp_path, servers):
        """A restart severs the pooled keep-alive socket; the next verb
        succeeds on one transparent redial with ``retries=0``."""
        root = str(tmp_path / "store")
        srv = _start(servers, root)
        host, port = srv.host, srv.port
        nt = _nt(srv.url, exp_key="e", retries=0)
        assert nt.new_trial_ids(1) == [0]
        r0 = _counter("rpc.pool.stale_reconnects")
        h0 = _counter("rpc.pool.hits")
        srv.shutdown()
        _start(servers, root, host=host, port=port)
        assert nt.new_trial_ids(1) == [1]
        assert _counter("rpc.pool.stale_reconnects") == r0 + 1
        assert _counter("rpc.pool.hits") == h0 + 1
        assert nt.new_trial_ids(1) == [2]
        assert _counter("rpc.pool.stale_reconnects") == r0 + 1


class TestPoolPoisonFlush:
    def test_failed_redial_flushes_sibling_corpses(self, tmp_path,
                                                   servers):
        """Several pooled sockets die with a restart and the redial for the
        first fails too: every sibling socket of that host is flushed at
        once, so later verbs never check out another corpse."""
        root = str(tmp_path / "store")
        srv = _start(servers, root)
        host, port = srv.host, srv.port

        def parked_reserve():
            _nt(srv.url, exp_key="e").reserve("w", wait_s=0.5)

        threads = [threading.Thread(target=parked_reserve)
                   for _ in range(3)]
        for t in threads:
            t.start()
        _join(threads)
        idle = netstore._rpc_pool()._idle.get((host, port), [])
        assert len(idle) == 3, "test needs 3 pooled sockets"
        f0 = _counter("rpc.pool.flushed")
        s0 = _counter("rpc.pool.stale_reconnects")
        srv.shutdown()
        srv2 = _start(servers, root, host=host, port=port)
        faults.configure({"rpc.connect": {"prob": 1.0, "times": 1}})
        nt = _nt(srv2.url, exp_key="e", retries=1)
        assert nt.new_trial_ids(1) == [0]
        assert _counter("rpc.pool.flushed") == f0 + 2
        assert _counter("rpc.pool.stale_reconnects") == s0 + 1
        assert nt.new_trial_ids(1) == [1]
        assert nt.new_trial_ids(1) == [2]
        assert _counter("rpc.pool.stale_reconnects") == s0 + 1
        assert _counter("rpc.pool.flushed") == f0 + 2


class TestLongPollClaims:
    def test_parked_reserve_wakes_on_insert(self, tmp_path, servers):
        srv = _start(servers, str(tmp_path / "store"))
        nt_w = _nt(srv.url, exp_key="e")
        nt_d = _nt(srv.url, exp_key="e")
        p0 = _counter("store.longpoll.parked")
        w0 = _counter("store.longpoll.woken")
        got = {}

        def worker():
            got["doc"] = nt_w.reserve("w0", wait_s=10.0)
            got["t"] = time.monotonic()

        t = threading.Thread(target=worker)
        t.start()
        assert _wait_for("store.longpoll.parked", p0 + 1) == p0 + 1
        t_ins = time.monotonic()
        nt_d._insert_trial_docs(_mk_docs([0], "e", [0.5]))
        _join([t])
        assert got["doc"] is not None and got["doc"]["tid"] == 0
        assert got["t"] - t_ins < 5.0
        assert _counter("store.longpoll.woken") == w0 + 1

    def test_empty_store_times_out_with_counter(self, tmp_path, servers):
        """The client's ``reserve_wait_s`` arms the long poll without a
        per-call opt-in."""
        srv = _start(servers, str(tmp_path / "store"))
        nt = _nt(srv.url, exp_key="e", reserve_wait_s=0.4)
        x0 = _counter("store.longpoll.timeouts")
        t0 = time.monotonic()
        assert nt.reserve("w0") is None
        elapsed = time.monotonic() - t0
        assert 0.35 <= elapsed < 5.0
        assert _counter("store.longpoll.timeouts") == x0 + 1

    def test_janitor_requeue_wakes_parked_reserve(self, tmp_path, servers):
        srv = _start(servers, str(tmp_path / "store"),
                     requeue_stale_every=0.05, stale_timeout=0.25)
        nt = _nt(srv.url, exp_key="e")
        nt._insert_trial_docs(_mk_docs([0], "e", [0.5]))
        dead = nt.reserve("w-dead")
        assert dead is not None and dead["tid"] == 0
        t0 = time.monotonic()
        doc = nt.reserve("w-live", wait_s=15.0)
        assert doc is not None and doc["tid"] == 0
        assert doc["owner"] == "w-live"
        assert time.monotonic() - t0 < 10.0

    def test_quota_slot_freed_rechecks_at_wake(self, tmp_path, servers):
        tt = TenantTable([Tenant("acme", "tok-a", max_claims=1)])
        srv = _start(servers, str(tmp_path / "store"), tenants=tt)
        nt = _nt(srv.url, exp_key="e", token="tok-a")
        nt._insert_trial_docs(_mk_docs([0, 1], "e", [0.1, 0.2]))
        d0 = nt.reserve("w0")
        assert d0 is not None
        got = {}

        def worker():
            got["doc"] = _nt(srv.url, exp_key="e", token="tok-a").reserve(
                "w1", wait_s=15.0)

        p0 = _counter("store.longpoll.parked")
        t = threading.Thread(target=worker)
        t.start()
        assert _wait_for("store.longpoll.parked", p0 + 1) == p0 + 1
        assert nt.write_result(_complete(d0, 1.0), owner="w0")
        _join([t])
        assert got["doc"] is not None and got["doc"]["tid"] == 1


class TestReadDispatchUnderWriteStall:
    def test_docs_answers_while_write_lock_held(self, tmp_path, servers):
        srv = _start(servers, str(tmp_path / "store"))
        nt = _nt(srv.url, exp_key="e")
        nt._insert_trial_docs(_mk_docs([0], "e", [0.5]))
        done = threading.Event()

        def mutator():
            nt.new_trial_ids(1)
            done.set()

        srv._lock.acquire()
        try:
            t = threading.Thread(target=mutator)
            t.start()
            time.sleep(0.1)
            t0 = time.monotonic()
            nt.refresh()
            read_s = time.monotonic() - t0
            assert [d["tid"] for d in nt._dynamic_trials] == [0]
            assert read_s < 5.0
            assert not done.is_set()
        finally:
            srv._lock.release()
        _join([t])
        assert done.is_set()

    def test_read_dispatch_off_arm_stays_correct(self, tmp_path, servers):
        srv = _start(servers, str(tmp_path / "store"), read_dispatch=False)
        assert srv._read_dispatch is False
        nt = _nt(srv.url, exp_key="e")
        nt._insert_trial_docs(_mk_docs([0, 1], "e", [0.1, 0.2]))
        nt.refresh()
        assert [d["tid"] for d in nt._dynamic_trials] == [0, 1]
        assert all(d["state"] == JOB_STATE_NEW for d in nt._dynamic_trials)

    def test_device_work_is_serialized_but_reads_are_not(self, tmp_path,
                                                         servers):
        """The suggest verb holds the server's device lock; a read verb
        answers while it is held, and a suggest waits for it."""
        from hyperopt_tpu_torch import hp

        srv = _start(servers, str(tmp_path / "store"))
        nt = _nt(srv.url, exp_key="e")
        dom = base.Domain(lambda d: d["x"], {"x": hp.uniform("x", 0, 1)})
        dom.cs.device = "cpu"
        nt.save_domain(dom)
        done = threading.Event()

        def suggest():
            nt.suggest(1, n=1, algo="rand")
            done.set()

        srv.device_lock.acquire()
        try:
            t = threading.Thread(target=suggest)
            t.start()
            time.sleep(0.2)
            nt.refresh()
            assert not done.is_set()
        finally:
            srv.device_lock.release()
        _join([t])
        assert done.is_set()
        nt.refresh()
        assert len(nt) == 1
