"""The PyTorch port's replicated, routed fleet against hyperopt_tpu's.

* **Router interop both ways**: a JAX ``RouterTrials`` works a port
  ``Router`` over port ``ShardServer`` primaries and replicas, and a port
  ``RouterTrials`` a JAX ``Router`` over JAX ``ShardServer``s, with the
  same docs, claims and results as a port client on a port fleet (store
  verbs only), including a failover.
* **Mirrors** on the port of ``tests/test_service_fleet.py``: every class
  (``TestHashRing`` for the cases ``test_torch_service_cluster.py`` does
  not cover), with ``TestRouterPlacement``'s dashboard rendering and the
  chaos test's trace merge through the port's ``show``, and of
  ``tests/test_lock_regressions.py``'s
  ``test_attach_replica_starts_shipper_outside_lock_after_publish``,
  ``test_router_metrics_fetch_passes_rpc_fault_point`` and
  ``test_wal_fanout_freezes_record_before_verb_executes``.  The JAX
  environment switches are the port's arguments here (the clients'
  first backoff is ``netstore.DEFAULT_BACKOFF_S``, the shard CLI's
  ``--wal-crash`` and ``--faults``); the chaos shards are child
  processes, SIGKILLed there.

Every server binds port 0 and is shut down by the test; every client,
join and child process has a timeout of its own.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import base, faults, hp, rand, show, tpe
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_OK
from hyperopt_tpu_torch.exceptions import InjectedFault, NetstoreUnavailable
from hyperopt_tpu_torch.obs import bundle as obs_bundle
from hyperopt_tpu_torch.obs import context as obs_context
from hyperopt_tpu_torch.obs import flight as obs_flight
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.obs.bundle import state_hash
from hyperopt_tpu_torch.obs.events import EVENTS
from hyperopt_tpu_torch.parallel import netstore
from hyperopt_tpu_torch.parallel.netstore import NetTrials, RouterTrials, _Rpc
from hyperopt_tpu_torch.service import Tenant, TenantTable
from hyperopt_tpu_torch.service import replica
from hyperopt_tpu_torch.service.cluster import HashRing, ShardMap, key_hash
from hyperopt_tpu_torch.service.replica import ShardServer, WalShipper
from hyperopt_tpu_torch.service.router import Router, _parse_shard_spec

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_fleet_state(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = metrics.metrics_enabled()
    metrics.set_enabled(True)
    monkeypatch.setattr(netstore, "DEFAULT_BACKOFF_S", 0.01)
    faults.clear()
    EVENTS.disable()
    EVENTS.clear()
    yield
    faults.clear()
    obs_flight.uninstall()
    obs_context.disable()
    EVENTS.disable()
    EVENTS.clear()
    metrics.set_enabled(was)
    torch.set_num_threads(n)


def _counter(name: str) -> float:
    return metrics.registry().snapshot().get("counters", {}).get(name, 0)


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


def _flush_all(servers):
    for s in servers:
        for sh in getattr(s, "_shippers", []):
            assert sh.flush()


def _scrub_pair(primary, rep):
    with primary._lock:
        p = (primary._wal.seq, state_hash(primary.state_bytes()))
    with rep._lock:
        r = (rep._wal.seq, state_hash(rep.state_bytes()))
    return p, r


class _Fleet:
    """In-process fleet: N shards (primary + warm replica each) + router,
    of the port or (``jax=True``) of the JAX package."""

    def __init__(self, tmp, n_shards=2, replicas=True, tenants=None,
                 token=None, jax=False, **router_kw):
        if jax:
            from hyperopt_tpu.service.replica import ShardServer as SS
            from hyperopt_tpu.service.router import Router as R
        else:
            SS, R = ShardServer, Router
        self.servers = []
        shards = {}
        kw = {"token": token} if token else {}
        if tenants is not None:
            kw["tenants"] = tenants
        for i in range(n_shards):
            prim = SS(wal_dir=os.path.join(tmp, f"s{i}p"), role="primary",
                      fsync="never", **kw)
            prim.start()
            entry = {"primary": prim.url, "replica": None}
            self.servers.append(prim)
            if replicas:
                repl = SS(wal_dir=os.path.join(tmp, f"s{i}r"),
                          role="replica", fsync="never", **kw)
                repl.start()
                prim.attach_replica(repl.url)
                entry["replica"] = repl.url
                self.servers.append(repl)
            shards[f"s{i}"] = entry
        self.router = R(shards, retries=1, backoff=0.01, token=token,
                        tenants=tenants, **router_kw)
        self.router.start()

    def primary(self, i):
        return self.servers[2 * i]

    def replica(self, i):
        return self.servers[2 * i + 1]

    def shutdown(self):
        self.router.shutdown()
        for s in self.servers:
            s.shutdown()


@pytest.fixture
def fleet_(tmp_path):
    f = _Fleet(str(tmp_path))
    yield f
    f.shutdown()


# ---------------------------------------------------------------------------
# router interop with the JAX package, both ways
# ---------------------------------------------------------------------------


def _routed_scenario(rt, jax_client):
    """Store verbs through a routed client; returns what a caller sees
    (the final docs without their wall-clock stamps)."""
    seen = [rt.new_trial_ids(4)]
    rt._insert_trial_docs(_mk_docs(seen[0], rt._exp_key,
                                   [0.5, -1.25, 2.0, 3.5]))
    d0 = rt.reserve("w0")
    d1 = rt.reserve("w1")
    seen += [d0["tid"], d1["tid"], rt.heartbeat(d0, owner="w0")]
    seen.append(rt.write_result(_complete(d0, 0.25), owner="w0"))
    seen.append(rt.write_result(_complete(dict(d1), 9.0), owner="w1"))
    rt.attachments["meta"] = {"k": [1, 2.5]}
    seen += [sorted(rt.attachments), rt.attachments["meta"]]
    rt.refresh()
    docs = [{k: v for k, v in d.items()
             if k not in ("book_time", "refresh_time")}
            for d in rt._dynamic_trials]
    return [seen, docs]


class TestRouterInterop:
    @pytest.mark.parametrize("fleet_pkg,client_pkg",
                             [("port", "jax"), ("jax", "port")])
    def test_router_trials_work_the_other_package_s_fleet(
            self, tmp_path, fleet_pkg, client_pkg):
        from hyperopt_tpu.parallel import netstore as jnet

        outs = {}
        for fpkg, pkg in ((fleet_pkg, client_pkg), ("port", "port")):
            f = _Fleet(str(tmp_path / f"{fpkg}-{pkg}"), jax=fpkg == "jax")
            try:
                RT = jnet.RouterTrials if pkg == "jax" else RouterTrials
                per_key = []
                for k in ("e0", "e1", "e2", "e3"):
                    rt = RT(f.router.url, exp_key=k, timeout=20.0)
                    per_key.append((rt.shard_id,
                                    _routed_scenario(rt, pkg == "jax")))
                # both shards served some store
                assert len({sid for sid, _ in per_key}) == 2
                # a failover: the owning primary of e0 dies
                rt = RT(f.router.url, exp_key="e0", retries=1,
                        timeout=20.0)
                i = int(rt.shard_id[1:])
                _flush_all(f.servers)
                f.primary(i)._httpd.shutdown()
                f.primary(i)._httpd.server_close()
                tid = rt.new_trial_ids(1)
                rt._insert_trial_docs(_mk_docs(tid, "e0", [0.75]))
                rt.refresh()
                per_key.append(sorted(d["tid"] for d in rt.trials))
                assert f.replica(i).role == "primary"
                outs[fpkg, pkg] = per_key
            finally:
                f.shutdown()
        assert outs[fleet_pkg, client_pkg] == outs["port", "port"]
        assert outs["port", "port"][-1] == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# mirrors: TestHashRing (the cases test_torch_service_cluster.py lacks)
# ---------------------------------------------------------------------------


class TestHashRing:
    def test_placement_hash_is_pinned(self):
        assert key_hash("acme", "exp-1") == 12520065837424943749
        assert key_hash(None, "default") == 13597278764869630297
        assert key_hash(None, "e") == key_hash("", "e")
        assert key_hash("ab", "c") != key_hash("a", "bc")

    def test_owner_deterministic_across_instances(self):
        a = HashRing(["s0", "s1", "s2"])
        b = HashRing([])
        for sid in ["s2", "s0", "s1"]:
            b.add(sid)
        keys = [(f"t{i}", f"e{i % 7}") for i in range(200)]
        assert [a.owner(*k) for k in keys] == [b.owner(*k) for k in keys]
        assert [a.owner(f"t{i}", "e") for i in range(6)] == \
            ["s2", "s0", "s0", "s0", "s1", "s2"]

    def test_resize_moves_about_k_over_n_keys(self):
        keys = [(f"tenant{i % 13}", f"exp{i}") for i in range(2000)]
        ring = HashRing([f"s{i}" for i in range(4)])
        before = [ring.owner(*k) for k in keys]
        ring.add("s4")
        after = [ring.owner(*k) for k in keys]
        moved = sum(1 for b, a in zip(before, after) if b != a)
        assert 0.05 * len(keys) < moved < 0.35 * len(keys)
        assert all(a == "s4" for b, a in zip(before, after) if b != a)
        ring.remove("s4")
        assert [ring.owner(*k) for k in keys] == before

    def test_shard_map_promote_and_versions(self):
        m = ShardMap({"s0": {"primary": "http://a/", "replica": "http://b"},
                      "s1": {"primary": "http://c", "replica": None}})
        assert m.version == 1
        assert m.shards["s0"]["primary"] == "http://a"   # rstripped
        ent = m.promote("s0")
        assert ent == {"primary": "http://b", "replica": None}
        assert m.version == 2
        with pytest.raises(ValueError, match="no replica"):
            m.promote("s1")
        m.set_primary("s1", "http://d", replica="http://e")
        assert m.version == 3
        doc = m.to_dict()
        m2 = ShardMap.from_dict(doc)
        assert m2.to_dict() == doc
        assert m2.owner("t", "e") == m.owner("t", "e")


# ---------------------------------------------------------------------------
# mirrors: TestReplication
# ---------------------------------------------------------------------------


class TestReplication:
    def test_tail_ship_scrub_byte_identity(self, tmp_path):
        prim = ShardServer(wal_dir=str(tmp_path / "p"), role="primary")
        repl = ShardServer(wal_dir=str(tmp_path / "r"), role="replica")
        prim.start(), repl.start()
        try:
            prim.attach_replica(repl.url)
            nt = NetTrials(prim.url, exp_key="e1", timeout=20.0)
            tids = nt.new_trial_ids(3)
            nt._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2, 0.3]))
            doc = nt.reserve("w0")
            assert nt.write_result(_complete(doc, 0.5), owner="w0")
            _flush_all([prim])
            p, r = _scrub_pair(prim, repl)
            assert p == r
            before = _counter("replica.scrub.ok")
            prim._shippers[0]._scrub_once()
            assert _counter("replica.scrub.ok") == before + 1
        finally:
            prim.shutdown(), repl.shutdown()

    def test_late_attach_installs_snapshot_then_tail(self, tmp_path):
        prim = ShardServer(wal_dir=str(tmp_path / "p"), role="primary")
        prim.start()
        repl = ShardServer(wal_dir=str(tmp_path / "r"), role="replica")
        repl.start()
        try:
            nt = NetTrials(prim.url, exp_key="e1", timeout=20.0)
            tids = nt.new_trial_ids(2)
            nt._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2]))
            prim.attach_replica(repl.url)           # snapshot path
            _flush_all([prim])
            assert _counter("replica.installs") >= 1
            nt._insert_trial_docs(_mk_docs(nt.new_trial_ids(1), "e1",
                                           [0.3]))  # tail path
            _flush_all([prim])
            p, r = _scrub_pair(prim, repl)
            assert p == r
        finally:
            prim.shutdown(), repl.shutdown()

    def test_replica_fences_client_wal_verbs(self, tmp_path):
        repl = ShardServer(wal_dir=str(tmp_path / "r"), role="replica")
        repl.start()
        try:
            nt = NetTrials(repl.url, exp_key="e1", retries=0, timeout=20.0)
            before = _counter("shard.fenced")
            with pytest.raises(RuntimeError, match="replica"):
                nt.new_trial_ids(1)
            assert _counter("shard.fenced") == before + 1
            nt.refresh()                            # reads pass
            _Rpc(repl.url, "e1")("promote")
            assert repl.role == "primary"
            assert nt.new_trial_ids(1) == [0]       # fence lifted
        finally:
            repl.shutdown()

    def test_shipped_records_repopulate_idem_cache(self, tmp_path):
        prim = ShardServer(wal_dir=str(tmp_path / "p"), role="primary")
        repl = ShardServer(wal_dir=str(tmp_path / "r"), role="replica")
        prim.start(), repl.start()
        try:
            prim.attach_replica(repl.url)
            rpc = _Rpc(prim.url, "e1")
            docs = _mk_docs([7], "e1", [0.5])
            out1 = rpc("insert_docs", docs=docs, idem="pinned-key-1")
            _flush_all([prim])
            _Rpc(repl.url, "e1")("promote")
            out2 = _Rpc(repl.url, "e1")(
                "insert_docs", docs=docs, idem="pinned-key-1")
            assert out2 == out1                     # cached reply
            repl_nt = NetTrials(repl.url, exp_key="e1", timeout=20.0)
            repl_nt.refresh()
            assert [d["tid"] for d in repl_nt.trials] == [7]  # no dupe
        finally:
            prim.shutdown(), repl.shutdown()

    def test_gap_forces_resync(self, tmp_path):
        repl = ShardServer(wal_dir=str(tmp_path / "r"), role="replica")
        repl.start()
        try:
            rpc = _Rpc(repl.url, "__replica__")
            rec = {"t": "2026-01-01T00:00:00Z", "verb": "new_trial_ids",
                   "tenant": None, "exp_key": "e1", "req": {"n": 1},
                   "idem": None, "seq": 5}
            out = rpc("wal_ship", records=[rec], from_seq=5)
            assert out["resync"] is True and out["applied"] == 0
            assert _counter("replica.gaps") >= 1
        finally:
            repl.shutdown()


# ---------------------------------------------------------------------------
# mirrors: TestRouterPlacement
# ---------------------------------------------------------------------------


class TestRouterPlacement:
    def test_stores_land_only_on_owning_shard(self, tmp_path):
        f = _Fleet(str(tmp_path), n_shards=3, replicas=False)
        try:
            exp_keys = [f"exp{i}" for i in range(12)]
            for ek in exp_keys:
                t = RouterTrials(f.router.url, exp_key=ek, timeout=20.0)
                t._insert_trial_docs(_mk_docs(t.new_trial_ids(1), ek,
                                              [0.1]))
            ring = HashRing([f"s{i}" for i in range(3)])
            for i in range(3):
                srv = f.servers[i]
                with srv._lock:
                    stored = {ek for (_, ek) in srv._trials}
                expect = {ek for ek in exp_keys
                          if ring.owner(None, ek) == f"s{i}"}
                assert stored == expect
        finally:
            f.shutdown()

    def test_forwarding_through_router_data_path(self, tmp_path):
        f = _Fleet(str(tmp_path), n_shards=2, replicas=False)
        try:
            nt = NetTrials(f.router.url, exp_key="e1", timeout=20.0)
            tids = nt.new_trial_ids(2)
            nt._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2]))
            doc = nt.reserve("w0")
            assert nt.write_result(_complete(doc, 1.0), owner="w0")
            nt.refresh()
            assert len(nt.trials) == 2
            assert _counter("router.forwarded") >= 5
        finally:
            f.shutdown()

    def test_cross_tenant_isolation_through_router(self, tmp_path):
        table = TenantTable([Tenant("acme", "tok-a"),
                             Tenant("zeta", "tok-z"),
                             Tenant("ops", "tok-ops")])
        f = _Fleet(str(tmp_path), n_shards=2, replicas=False,
                   tenants=table, token="tok-ops")
        try:
            ta = RouterTrials(f.router.url, exp_key="e", token="tok-a")
            tz = RouterTrials(f.router.url, exp_key="e", token="tok-z")
            assert ta._rpc.tenant == "acme" and tz._rpc.tenant == "zeta"
            ta._insert_trial_docs(_mk_docs(ta.new_trial_ids(2), "e",
                                           [0.1, 0.2]))
            tz._insert_trial_docs(_mk_docs(tz.new_trial_ids(1), "e",
                                           [0.9]))
            ta.refresh(), tz.refresh()
            assert len(ta.trials) == 2 and len(tz.trials) == 1
            vals = [d["misc"]["vals"]["x"][0] for d in tz.trials]
            assert vals == [0.9]
            with pytest.raises(RuntimeError, match="AuthError"):
                _Rpc(f.router.url, "e", token="bogus")("shard_map")
        finally:
            f.shutdown()

    def test_metrics_merged_and_degraded_shard(self, tmp_path):
        """A dead shard degrades the router's merged ``/metrics`` payload
        to a DOWN row; ``show live`` renders both rows."""
        f = _Fleet(str(tmp_path), n_shards=2, replicas=False)
        try:
            nt = NetTrials(f.router.url, exp_key="e1", timeout=20.0)
            nt.new_trial_ids(1)
            f.servers[1]._httpd.shutdown()          # kill s1, keep s0
            f.servers[1]._httpd.server_close()
            snap = f.router.metrics_payload()
            r = snap["router"]
            assert r["n_shards"] == 2
            oks = {sid: info["ok"] for sid, info in r["shards"].items()}
            assert sorted(oks.values()) == [False, True]
            down = [i for i in r["shards"].values() if not i["ok"]][0]
            assert "error" in down
            assert "merged" in snap and "counters" in snap["merged"]
            buf = io.StringIO()
            show.render_live(snap, out=buf)
            text = buf.getvalue()
            assert "router: 2 shard(s)" in text
            assert "DOWN" in text and "ok" in text
        finally:
            f.shutdown()

    def test_render_live_empty_and_routerless_snapshots(self):
        """The dashboard degrades cleanly: no router section -> no shard
        panel; a router section with zero reachable shards still
        renders a frame."""
        buf = io.StringIO()
        show.render_live({}, out=buf)
        assert "fleet: 0 worker(s)" in buf.getvalue()
        assert "router:" not in buf.getvalue()
        buf = io.StringIO()
        show.render_live(
            {"router": {"version": 4, "n_shards": 1, "shards": {
                "s0": {"url": "http://x", "replica": None, "ok": False,
                       "error": "URLError: refused"}}}}, out=buf)
        text = buf.getvalue()
        assert "router: 1 shard(s)" in text and "map v4" in text
        assert "DOWN" in text and "URLError: refused" in text

    def test_parse_shard_spec(self):
        assert _parse_shard_spec("s0=http://a,http://b") == \
            ("s0", {"primary": "http://a", "replica": "http://b"})
        assert _parse_shard_spec("s1=http://c") == \
            ("s1", {"primary": "http://c", "replica": None})
        with pytest.raises(ValueError, match="--shard"):
            _parse_shard_spec("nourl")


# ---------------------------------------------------------------------------
# mirrors: TestFailover, TestRebalance
# ---------------------------------------------------------------------------


class TestFailover:
    def test_kill_primary_promotes_replica_exactly_once(self, fleet_):
        t = RouterTrials(fleet_.router.url, exp_key="e1", retries=1)
        i = int(t.shard_id[1:])
        tids = t.new_trial_ids(2)
        t._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2]))
        _flush_all(fleet_.servers)
        prim, repl = fleet_.primary(i), fleet_.replica(i)
        prim._httpd.shutdown()
        prim._httpd.server_close()
        doc = t.reserve("w0")
        assert t.write_result(_complete(doc, 1.0), owner="w0")
        assert repl.role == "primary"
        assert _counter("router.failovers") >= 1
        assert _counter("netstore.client.reroutes") >= 1
        t.refresh()
        seen = [d["tid"] for d in t.trials]
        assert sorted(seen) == sorted(tids)          # zero lost
        assert len(seen) == len(set(seen))           # zero duplicated
        assert t._rpc.url == repl.url

    def test_failover_without_replica_surfaces_unavailable(self,
                                                           tmp_path):
        f = _Fleet(str(tmp_path), n_shards=1, replicas=False)
        try:
            nt = NetTrials(f.router.url, exp_key="e1", retries=1,
                           timeout=20.0)
            f.servers[0]._httpd.shutdown()
            f.servers[0]._httpd.server_close()
            with pytest.raises((NetstoreUnavailable, RuntimeError)):
                nt.new_trial_ids(1)
        finally:
            f.shutdown()

    def test_failback_rejoin_is_byte_identical(self, fleet_):
        t = RouterTrials(fleet_.router.url, exp_key="e1")
        i = int(t.shard_id[1:])
        t._insert_trial_docs(_mk_docs(t.new_trial_ids(2), "e1",
                                      [0.1, 0.2]))
        _flush_all(fleet_.servers)
        prim, repl = fleet_.primary(i), fleet_.replica(i)
        prim._httpd.shutdown()
        prim._httpd.server_close()
        t.reserve("w0")                              # forces promotion
        assert repl.role == "primary"
        t._insert_trial_docs(_mk_docs(t.new_trial_ids(1), "e1", [0.3]))
        rejoin = ShardServer(wal_dir=prim.wal_root + "-rejoin",
                             role="replica")
        rejoin.start()
        try:
            _Rpc(repl.url, "e1")("replica_attach", url=rejoin.url)
            _flush_all([repl])
            p, r = _scrub_pair(repl, rejoin)
            assert p == r
        finally:
            rejoin.shutdown()


class TestRebalance:
    def test_rebalance_moves_shard_byte_identically(self, tmp_path):
        f = _Fleet(str(tmp_path), n_shards=1, replicas=False)
        new = ShardServer(wal_dir=str(tmp_path / "new"), role="replica")
        new.start()
        try:
            t = RouterTrials(f.router.url, exp_key="e1", map_refresh_s=0.0)
            t._insert_trial_docs(_mk_docs(t.new_trial_ids(3), "e1",
                                          [0.1, 0.2, 0.3]))
            out = _Rpc(f.router.url, "e1")("rebalance", shard="s0",
                                           url=new.url)
            assert out["primary"] == new.url
            assert out["cutover_ms"] < 5000.0        # bounded window
            assert new.role == "primary"
            p, r = _scrub_pair(f.servers[0], new)
            assert p == r                            # byte-identical move
            assert _counter("router.rebalances") >= 1
            doc = t.reserve("w0")
            assert t._rpc.url == new.url
            assert t.write_result(_complete(doc, 1.0), owner="w0")
        finally:
            new.shutdown()
            f.shutdown()

    def test_rebalance_unknown_shard_is_an_error(self, tmp_path):
        f = _Fleet(str(tmp_path), n_shards=1, replicas=False)
        try:
            with pytest.raises(RuntimeError, match="unknown shard"):
                _Rpc(f.router.url, "e1")("rebalance", shard="nope",
                                         url="http://x")
        finally:
            f.shutdown()


# ---------------------------------------------------------------------------
# mirrors: the chaos classes (child shard processes)
# ---------------------------------------------------------------------------


def _launch_shard(args):
    """``python -m hyperopt_tpu_torch.service.replica --serve ARGS`` in a
    child process; returns ``(proc, url)``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperopt_tpu_torch.service.replica",
         "--serve"] + args, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = None
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stdout.readline()
        m = re.search(r"shard: serving .* at (http://\S+)", line)
        if m:
            url = m.group(1)
            break
        if proc.poll() is not None:
            pytest.fail(f"shard died on startup: {proc.stdout.read()}")
    if url is None:
        proc.kill()
        pytest.fail("shard never printed its URL")
    return proc, url


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)
    proc.stdout.close()


@pytest.mark.chaos
class TestChaosFleetKill:
    def test_sigkill_primary_failover_exactly_once_and_bundle(
            self, tmp_path):
        """A child shard primary is SIGKILLed at the WAL append of a
        forwarded ``write_result`` (appends: new_trial_ids, insert_docs,
        then (reserve, write) pairs: ``@4``).  The router promotes the
        warm replica; the pinned idem key and the shipped records make the
        retried verb exactly-once; the killed process froze a flight
        bundle whose events carry the client's trace id, and the bundle
        splices into a merged trace as a lane."""
        flight_dir = str(tmp_path / "flight")
        rp, rurl = _launch_shard(
            ["--wal-dir", str(tmp_path / "r"), "--role", "replica"])
        pp, purl = _launch_shard(
            ["--wal-dir", str(tmp_path / "p"), "--role", "primary",
             "--replicate-to", rurl, "--flight-dir", flight_dir,
             "--wal-crash", "kill", "--faults", "wal.write=1.0:1@4"])
        router = Router({"s0": {"primary": purl, "replica": rurl}},
                        retries=1, backoff=0.01)
        router.start()
        try:
            obs_context.enable()
            trace_id = obs_context.new_trace_id()
            with obs_context.bind(trace_id=trace_id):
                t = RouterTrials(router.url, exp_key="e1", retries=1,
                                 timeout=20.0)
                tids = t.new_trial_ids(4)
                t._insert_trial_docs(_mk_docs(tids, "e1",
                                              [0.1, 0.2, 0.3, 0.4]))
                for _ in range(4):
                    doc = t.reserve("w0")
                    assert t.write_result(_complete(doc, 1.0),
                                          owner="w0")
            assert pp.wait(timeout=20) == -signal.SIGKILL
            assert _counter("router.failovers") >= 1
            t.refresh()
            seen = [d["tid"] for d in t.trials]
            assert sorted(seen) == [0, 1, 2, 3]
            assert len(seen) == len(set(seen))
            assert all(d["state"] == JOB_STATE_DONE for d in t.trials)
            bundles = [p for p in os.listdir(flight_dir)
                       if p.startswith("bundle-")]
            assert len(bundles) == 1
            payload = obs_bundle.read_bundle(
                os.path.join(flight_dir, bundles[0]))
            assert payload["manifest"]["reason"] == "wal-crash"
            assert payload["manifest"]["extra"]["trigger"] == "wal_crash"
            traced = {e.get("trace_id") for e in payload["events"]}
            assert trace_id in traced
            bdir = os.path.join(flight_dir, bundles[0])
            buf = io.StringIO()
            doc = show.merge_traces([bdir], out=buf)
            assert doc["otherData"]["n_lanes"] == 1
            assert "missing" not in buf.getvalue()
            assert trace_id in json.dumps(doc)
        finally:
            router.shutdown()
            _stop(pp), _stop(rp)

    @pytest.mark.slow
    def test_seeded_kill_schedule_long(self, tmp_path):
        """Three primary generations on one shard (kill → promote → a
        fresh standby rejoins → kill again) under a deterministic verb
        stream: zero lost or duplicated tids after every round, and a
        final rejoiner scrubs to the survivor's (seq, hash)."""
        by_url = {}
        rp, rurl = _launch_shard(
            ["--wal-dir", str(tmp_path / "r0"), "--role", "replica"])
        pp, purl = _launch_shard(
            ["--wal-dir", str(tmp_path / "p0"), "--role", "primary",
             "--replicate-to", rurl])
        by_url[rurl], by_url[purl] = rp, pp
        router = Router({"s0": {"primary": purl, "replica": rurl}},
                        retries=1, backoff=0.01)
        router.start()

        def _catch_up(src_url, dst_url, require_hash=False):
            a, b = _Rpc(src_url, "e1"), _Rpc(dst_url, "e1")
            deadline = time.time() + 30
            while True:
                sa, sb = a("scrub"), b("scrub")
                if sa["seq"] == sb["seq"] and (
                        not require_hash or sa["hash"] == sb["hash"]):
                    return sa, sb
                assert time.time() < deadline, "standby never caught up"
                time.sleep(0.05)

        try:
            t = RouterTrials(router.url, exp_key="e1", retries=1,
                             map_refresh_s=0.0)
            expected = []
            n_rounds = 3
            for round_no in range(n_rounds):
                for _ in range(6):
                    tid = t.new_trial_ids(1)[0]
                    t._insert_trial_docs(_mk_docs([tid], "e1",
                                                  [0.1 * (tid + 1)]))
                    expected.append(tid)
                t.refresh()
                seen = [d["tid"] for d in t.trials]
                assert sorted(seen) == sorted(expected)
                assert len(seen) == len(set(seen))
                if round_no == n_rounds - 1:
                    break
                np_, nurl = _launch_shard(
                    ["--wal-dir", str(tmp_path / f"j{round_no}"),
                     "--role", "replica"])
                by_url[nurl] = np_
                cur = router.shard_for(None, "e1")[1]["primary"]
                _Rpc(cur, "e1")("replica_attach", url=nurl)
                with router._lock:
                    router._map.shards["s0"]["replica"] = nurl
                _catch_up(cur, nurl)
                os.kill(by_url[cur].pid, signal.SIGKILL)
                assert by_url[cur].wait(timeout=10) == -signal.SIGKILL
            cur = router.shard_for(None, "e1")[1]["primary"]
            fp, furl = _launch_shard(
                ["--wal-dir", str(tmp_path / "final"), "--role",
                 "replica"])
            by_url[furl] = fp
            _Rpc(cur, "e1")("replica_attach", url=furl)
            sa, sb = _catch_up(cur, furl, require_hash=True)
            assert sa["hash"] == sb["hash"]
            assert _counter("router.failovers") >= 2
        finally:
            router.shutdown()
            for p in by_url.values():
                _stop(p)


def _gate_domain():
    space = {"x": hp.uniform("x", -5, 5),
             "lr": hp.loguniform("lr", -6, 0),
             "c": hp.choice("c", [{"a": hp.normal("a", 0, 1)}, {"k": 2}])}
    dom = base.Domain(lambda d: d["x"] ** 2, space)
    dom.cs.device = CPU
    return dom


def _run_exp(dom, n, seed0, trials):
    rng = np.random.default_rng(seed0)
    for i in range(n):
        trials.insert_trial_docs(
            rand.suggest([i], dom, trials, int(rng.integers(2 ** 31))))
        trials.refresh()
        d = trials._dynamic_trials[-1]
        d["state"] = JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    trials.refresh()
    return trials


@pytest.mark.chaos
class TestCohortGateSurvivesFailover:
    def test_sigkill_mid_cohort_promoted_replica_resumes_batching(
            self, tmp_path):
        """A child primary serving a two-tenant cohort is SIGKILLed at
        the suggest's WAL append (appends: (put_domain, insert_docs) x 2:
        ``@4``).  Both suggests land exactly once on the promoted replica,
        which arms its cohort gate and batches the next pair."""
        rp, rurl = _launch_shard(
            ["--wal-dir", str(tmp_path / "r"), "--role", "replica",
             "--cohort-window-ms", "300"])
        pp, purl = _launch_shard(
            ["--wal-dir", str(tmp_path / "p"), "--role", "primary",
             "--replicate-to", rurl, "--cohort-window-ms", "300",
             "--wal-crash", "kill", "--faults", "wal.write=1.0:1@4"])
        router = Router({"s0": {"primary": purl, "replica": rurl}},
                        retries=1, backoff=0.01)
        router.start()
        try:
            nts = []
            for e in ("e1", "e2"):
                dom = _gate_domain()
                local = base.Trials(exp_key=e)
                _run_exp(dom, 22, 50 + len(nts), local)
                nt = RouterTrials(router.url, exp_key=e, retries=2,
                                  timeout=30.0)
                nt.save_domain(dom)
                nt._insert_trial_docs(
                    json.loads(json.dumps(list(local._dynamic_trials))))
                nts.append(nt)
            time.sleep(0.5)   # let the shipper drain the setup appends
            out = [None, None]

            def _r1(i):
                out[i] = nts[i].suggest(901 + i, n=1)

            ts = [threading.Thread(target=_r1, args=(i,)) for i in (0, 1)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=60)
            assert pp.wait(timeout=20) == -signal.SIGKILL
            assert _counter("router.failovers") >= 1
            assert out[0] and out[1]   # both retried suggests served
            for nt in nts:
                nt.refresh()
                tids = [d["tid"] for d in nt.trials]
                assert len(tids) == 23
                assert len(tids) == len(set(tids))
            snap0 = NetTrials(rurl, exp_key="e1", timeout=20.0).metrics()
            d0 = snap0.get("counters", {}).get("fleet.dispatches", 0)
            barrier = threading.Barrier(2)

            def _r2(i):
                barrier.wait()
                nts[i].suggest(911 + i, new_ids=[600], insert=False)

            ts = [threading.Thread(target=_r2, args=(i,)) for i in (0, 1)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=60)
            snap = NetTrials(rurl, exp_key="e1", timeout=20.0).metrics()
            ctr = snap.get("counters", {})
            assert ctr.get("shard.promotions", 0) >= 1
            assert ctr.get("shard.cohort_gate_armed", 0) >= 1, \
                "promoted replica never armed its cohort gate"
            assert ctr.get("fleet.dispatches", 0) >= d0 + 1, \
                "promoted replica served the concurrent pair solo"
        finally:
            router.shutdown()
            _stop(pp)
            _stop(rp)


# ---------------------------------------------------------------------------
# server-side suggests through the router equal the in-process ones
# ---------------------------------------------------------------------------


class TestRoutedSuggest:
    def test_router_trials_suggest_equals_in_process(self, fleet_):
        for e in ("e0", "e1", "e2"):
            dom = _gate_domain()
            local = base.Trials(exp_key=e)
            _run_exp(dom, 24, 7, local)
            rt = RouterTrials(fleet_.router.url, exp_key=e, timeout=20.0)
            rt.save_domain(dom)
            rt._insert_trial_docs(
                json.loads(json.dumps(list(local._dynamic_trials))))
            got = rt.suggest(33, new_ids=[24, 25], insert=False)
            ref = tpe.suggest([24, 25], dom, local, 33, verbose=False)
            assert got == json.loads(json.dumps(ref))


# ---------------------------------------------------------------------------
# mirrors: test_lock_regressions.py's service cases
# ---------------------------------------------------------------------------


def test_attach_replica_starts_shipper_outside_lock_after_publish(
        monkeypatch, tmp_path):
    server = replica.ShardServer(str(tmp_path))
    try:
        started = []

        def recording_start(self):
            started.append((server._lock._is_owned()
                            if hasattr(server._lock, "_is_owned")
                            else server._lock.locked(),
                            self in server._shippers))
            return self          # never start the real network thread

        monkeypatch.setattr(replica.WalShipper, "start", recording_start)
        barrier = threading.Barrier(2)
        got = []

        def attach():
            barrier.wait()
            got.append(server.attach_replica("http://127.0.0.1:1/r"))

        threads = [threading.Thread(target=attach) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        assert got[0] is got[1]              # one shipper per URL
        assert len(server._shippers) == 1
        assert started == [(False, True)]
        assert all(sh._thread.ident is not None or sh in server._shippers
                   for sh in got)
    finally:
        server.shutdown()


def test_router_metrics_fetch_passes_rpc_fault_point():
    router = object.__new__(Router)
    router._token = None
    router.timeout = 1.0
    faults.configure({"rpc.send": 1.0})
    try:
        with pytest.raises(InjectedFault):
            router._fetch_shard_metrics("http://127.0.0.1:9")
    finally:
        faults.configure({})


def test_wal_fanout_freezes_record_before_verb_executes(tmp_path,
                                                        monkeypatch):
    orig_batch = WalShipper._ship_batch

    def delayed_batch(self, batch):
        time.sleep(0.25)
        return orig_batch(self, batch)

    monkeypatch.setattr(WalShipper, "_ship_batch", delayed_batch)
    prim = ShardServer(wal_dir=str(tmp_path / "p"), role="primary")
    repl = ShardServer(wal_dir=str(tmp_path / "r"), role="replica")
    try:
        prim.start()
        repl.start()
        prim.attach_replica(repl.url)
        time.sleep(0.2)  # let the initial snapshot land
        nt = NetTrials(prim.url, exp_key="e1", timeout=20.0)
        docs = []
        for tid in nt.new_trial_ids(3):
            d = base.new_trial_doc(tid, "e1", None)
            d["misc"]["idxs"] = {"x": [tid]}
            d["misc"]["vals"] = {"x": [float(tid)]}
            docs.append(d)
        nt._insert_trial_docs(docs)
        doc = nt.reserve("w0")
        doc["state"] = JOB_STATE_DONE
        doc["result"] = {"status": STATUS_OK, "loss": 0.5}
        nt.write_result(doc, owner="w0")
        for sh in prim._shippers:
            assert sh.flush()
        p, r = _scrub_pair(prim, repl)
        assert p == r
    finally:
        prim.shutdown()
        repl.shutdown()
