"""The PyTorch port's elastic fleet: migration, ``shard_add``/
``shard_remove`` and the autoscaler.

Mirrors on the port of every class of ``tests/test_service_elastic.py``:
placement pins, ``map_sync`` between peer routers, per-store migration
(``store_fence`` → ``store_export`` → ``store_import`` → pin) with its
rollback and failover paths, parked long-poll claims across a fence, the
``shed`` directive and typed ``Backpressure``, the autoscaler's decision
table with its WAL-durable decision log, single-flight promotion and
replica chains.  The JAX environment switches are the port's arguments
here: the clients' first backoff is ``netstore.DEFAULT_BACKOFF_S``, the
load-shed honor budget ``NetTrials(backpressure_retries=)``, and the
autoscaler's period, cooldown and shard bounds its constructor's
arguments; the single-flight test's primary is a child process,
SIGKILLed there.

Every server binds port 0 and is shut down by the test; every client,
join and child process has a timeout of its own.
"""

import os
import signal
import threading
import time

import pytest
import torch

from hyperopt_tpu_torch import base, faults
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_OK
from hyperopt_tpu_torch.exceptions import Backpressure, ShardFenced
from hyperopt_tpu_torch.obs import context as obs_context
from hyperopt_tpu_torch.obs import flight as obs_flight
from hyperopt_tpu_torch.obs import metrics as _metrics
from hyperopt_tpu_torch.obs.events import EVENTS
from hyperopt_tpu_torch.parallel import netstore
from hyperopt_tpu_torch.parallel.netstore import NetTrials, RouterTrials, _Rpc
from hyperopt_tpu_torch.service.autoscaler import Autoscaler, LocalSpawner
from hyperopt_tpu_torch.service.cluster import HashRing, ShardMap
from hyperopt_tpu_torch.service.replica import ShardServer
from hyperopt_tpu_torch.service.router import Router


@pytest.fixture(autouse=True)
def _clean_elastic_state(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = _metrics.metrics_enabled()
    _metrics.set_enabled(True)
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
    _metrics.set_enabled(was)
    torch.set_num_threads(n)


def _counter(name: str) -> float:
    return _metrics.registry().snapshot().get("counters", {}).get(name, 0)


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


def _wait_counter(name, floor, timeout=5.0):
    deadline = time.monotonic() + timeout
    while _counter(name) < floor and time.monotonic() < deadline:
        time.sleep(0.01)
    return _counter(name)


def _scrub(url):
    out = _Rpc(url, "__scrub__")("scrub")
    return out["seq"], out["hash"]


def _catch_up(src_url, dst_url, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _scrub(dst_url)[0] >= _scrub(src_url)[0]:
            return
        time.sleep(0.02)
    raise AssertionError(f"{dst_url} never caught up to {src_url}")


# ---------------------------------------------------------------------------
# ShardMap pins: the migration's bounded in-between state
# ---------------------------------------------------------------------------


class TestShardMapPins:
    def _map(self):
        return ShardMap({"s0": {"primary": "http://h:1", "replica": None},
                         "s1": {"primary": "http://h:2", "replica": None}})

    def test_pin_overrides_ring_and_bumps_version(self):
        m = self._map()
        # Find a key the ring places on s0 and pin it to s1.
        key = next(k for k in (f"e{i}" for i in range(64))
                   if m.ring.owner(None, k) == "s0")
        v0 = m.version
        m.pin(None, key, "s1")
        assert m.version == v0 + 1
        assert m.owner(None, key)[0] == "s1"
        # Other keys keep their ring placement.
        other = next(k for k in (f"e{i}" for i in range(64))
                     if m.ring.owner(None, k) == "s1" and k != key)
        assert m.owner(None, other)[0] == "s1"

    def test_pin_to_unknown_shard_refused(self):
        m = self._map()
        with pytest.raises(ValueError):
            m.pin(None, "e0", "nope")

    def test_pins_ride_the_wire_document(self):
        m = self._map()
        m.pin("acme", "e0", "s1")
        doc = m.to_dict()
        assert doc["pins"] == {ShardMap.pin_key("acme", "e0"): "s1"}
        m2 = ShardMap.from_dict(doc)
        assert m2.owner("acme", "e0")[0] == "s1"
        assert m2.version == m.version
        # Tenant-namespaced pin never leaks to the anonymous key.
        assert (m2.owner(None, "e0")[0]
                == m2.ring.owner(None, "e0"))

    def test_remove_shard_drops_its_pins(self):
        m = self._map()
        m.shards["s2"] = {"primary": "http://h:3", "replica": None}
        m.ring.add("s2")
        m.pin(None, "e0", "s2")
        m.pin(None, "e1", "s1")
        m.remove_shard("s2")
        assert ShardMap.pin_key(None, "e0") not in m.pins
        assert m.pins[ShardMap.pin_key(None, "e1")] == "s1"

    def test_clear_pins_bumps_version_only_when_present(self):
        m = self._map()
        v0 = m.version
        m.clear_pins()
        assert m.version == v0          # nothing to clear: no bump
        m.pin(None, "e0", "s1")
        m.clear_pins()
        assert not m.pins
        assert m.version == v0 + 2

    def test_from_dict_drops_pins_to_unknown_shards(self):
        doc = self._map().to_dict()
        doc["pins"] = {ShardMap.pin_key(None, "e0"): "ghost"}
        m = ShardMap.from_dict(doc)
        assert not m.pins               # unknown target: pin discarded


# ---------------------------------------------------------------------------
# multi-router HA: map_sync gossip, adopt-iff-newer
# ---------------------------------------------------------------------------


class TestMapSyncHA:
    def test_adopt_iff_newer_and_symmetric_reconcile(self):
        shards = {"s0": {"primary": "http://127.0.0.1:1", "replica": None}}
        a = Router(shards, retries=0, backoff=0.01)
        b = Router(shards, retries=0, backoff=0.01)
        a._peers = [b.url]
        a.start(), b.start()
        try:
            # A mutates its map (version 2) and pushes: B adopts.
            ad0 = _counter("router.map.adopted")
            with a._lock:
                a._map.pin(None, "e0", "s0")
            a._push_map_to_peers()
            assert b._map.version == 2
            assert b._map.pins == {ShardMap.pin_key(None, "e0"): "s0"}
            assert _counter("router.map.adopted") == ad0 + 1

            # Same version again: refused (not strictly newer).
            out = _Rpc(b.url, "ctl")("map_sync", map=a._map.to_dict())
            assert out["adopted"] is False
            assert out["map"]["version"] == 2

            # B races ahead; A's next push reconciles SYMMETRICALLY —
            # the reply carried a newer map and A adopted it.
            with b._lock:
                b._map.pin(None, "e1", "s0")
                b._map.pin(None, "e2", "s0")
            assert b._map.version == 4
            a._push_map_to_peers()
            assert a._map.version == 4
            assert ShardMap.pin_key(None, "e2") in a._map.pins
        finally:
            a.shutdown(), b.shutdown()

    def test_adopt_refused_mid_cutover_and_malformed(self):
        shards = {"s0": {"primary": "http://127.0.0.1:1", "replica": None}}
        b = Router(shards, retries=0, backoff=0.01)
        newer = ShardMap(shards, version=9).to_dict()
        b._cutover["s0"] = threading.Event()
        assert b._adopt_map(newer) is False       # never mid-cutover
        b._cutover.clear()
        assert b._adopt_map({"bogus": 1}) is False  # malformed: refused
        assert b._adopt_map(newer) is True
        assert b._map.version == 9


# ---------------------------------------------------------------------------
# elastic shard_add / shard_remove: per-store migration round trip
# ---------------------------------------------------------------------------


class TestElasticShardAddRemove:
    def test_grow_then_shrink_zero_lost_zero_duplicated(self, tmp_path,
                                                        monkeypatch):
        """Six stores on one shard; ``shard_add`` migrates exactly the
        ring-moved subset with bounded per-store cutovers (donor copies
        become fenced tombstones), ``shard_remove`` brings them home —
        and every tid survives both moves exactly once, completed state
        included."""
        keys = [f"e{i}" for i in range(6)]
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None}},
                        retries=1, backoff=0.01)
        router.start()
        srv1 = ShardServer(str(tmp_path / "s1"), role="primary",
                           fsync="never")
        srv1.start()
        try:
            for k in keys:
                t = RouterTrials(router.url, exp_key=k, retries=1,
                                 map_refresh_s=0.0)
                tids = t.new_trial_ids(3)
                t._insert_trial_docs(_mk_docs(tids, k, [0.1, 0.2, 0.3]))
                doc = t.reserve("w0")
                assert t.write_result(_complete(doc, 1.0), owner="w0")

            ring2 = HashRing(["s0", "s1"])
            moved = [k for k in keys if ring2.owner(None, k) == "s1"]
            assert moved                     # the grow must move stores

            ctl = _Rpc(router.url, "__ctl__")
            out = ctl("shard_add", shard="s1", url=srv1.url)
            assert out["migrated"] == len(moved)
            assert out["held"] == 0

            # Terminal state: ring and placement agree, no pins linger.
            with router._lock:
                assert not router._map.pins
            for k in moved:
                assert router.shard_for(None, k)[0] == "s1"

            # Donor copies are fenced tombstones: reads redirect, and
            # the inventory shows them emptied.
            with pytest.raises(ShardFenced):
                _Rpc(srv0.url, moved[0])("docs")
            rows = {r["exp_key"]: r
                    for r in _Rpc(srv0.url, "x")("stores")["stores"]}
            for k in moved:
                assert rows[k]["fenced"] and rows[k]["docs"] == 0

            # Zero lost, zero duplicated, completed state preserved —
            # and NEW writes land on the new owner.
            for k in keys:
                t = RouterTrials(router.url, exp_key=k, retries=1,
                                 map_refresh_s=0.0)
                t.refresh()
                tids = [d["tid"] for d in t.trials]
                assert sorted(tids) == [0, 1, 2]
                assert len(tids) == len(set(tids))
                assert sum(d["state"] == JOB_STATE_DONE
                           for d in t.trials) == 1
            t = RouterTrials(router.url, exp_key=moved[0], retries=1,
                             map_refresh_s=0.0)
            assert t.new_trial_ids(1) == [3]
            assert t._rpc.shard_id == "s1"
            t._insert_trial_docs(_mk_docs([3], moved[0], [0.4]))

            # Shrink: everything returns to s0, s1 leaves the map.
            out = ctl("shard_remove", shard="s1")
            assert out["migrated"] == len(moved)
            with router._lock:
                assert list(router._map.shards) == ["s0"]
                assert not router._map.pins
            for k in keys:
                t = RouterTrials(router.url, exp_key=k, retries=1,
                                 map_refresh_s=0.0)
                t.refresh()
                tids = [d["tid"] for d in t.trials]
                want = [0, 1, 2, 3] if k == moved[0] else [0, 1, 2]
                assert sorted(tids) == want
                assert len(tids) == len(set(tids))
            assert _counter("router.migrated_stores") >= 2 * len(moved)
        finally:
            router.shutdown()
            srv0.shutdown(), srv1.shutdown()

    def test_remove_refuses_last_shard_and_unknown(self, tmp_path):
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None}},
                        retries=0, backoff=0.01)
        try:
            with pytest.raises(ValueError):
                router._shard_remove_verb({"shard": "s0"})
            with pytest.raises(ValueError):
                router._shard_remove_verb({"shard": "ghost"})
        finally:
            router.shutdown()
            srv0.shutdown()

    def test_topology_changes_are_mutually_exclusive(self, tmp_path):
        """A second topology verb while one is in flight is refused
        loudly instead of interleaving two migrations."""
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None}},
                        retries=0, backoff=0.01)
        try:
            assert router._topology_lock.acquire(blocking=False)
            try:
                with pytest.raises(RuntimeError, match="in progress"):
                    router._shard_add_verb(
                        {"shard": "s1", "url": "http://127.0.0.1:1"})
            finally:
                router._topology_lock.release()
        finally:
            router.shutdown()
            srv0.shutdown()


# ---------------------------------------------------------------------------
# migration failure atomicity: a half-cutover must roll its fence back
# ---------------------------------------------------------------------------


class TestMigrationRollback:
    def test_failed_import_lifts_fence_and_strands_nothing(self, tmp_path):
        """``store_import`` into a dead destination (no replica to fail
        over to) aborts the shrink — and the donor's fence is LIFTED,
        so the store keeps serving instead of wedging behind a
        tombstone that a later retry would mistake for moved data."""
        import socket

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        dead_url = "http://127.0.0.1:%d" % sock.getsockname()[1]
        sock.close()                     # nothing listens here any more
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None},
                         "s1": {"primary": dead_url, "replica": None}},
                        retries=0, backoff=0.01)
        try:
            keys = [f"e{i}" for i in range(4)]
            for k in keys:
                t = NetTrials(srv0.url, exp_key=k, retries=0)
                t._insert_trial_docs(_mk_docs(t.new_trial_ids(2), k,
                                              [0.1, 0.2]))
            from hyperopt_tpu_torch.exceptions import NetstoreUnavailable

            with pytest.raises(NetstoreUnavailable):
                router._shard_remove_verb({"shard": "s0"})

            # The shrink aborted atomically: s0 is still in the map and
            # NO store on it is fenced — mutations flow everywhere.
            with router._lock:
                assert "s0" in router._map.shards
            rows = _Rpc(srv0.url, "x")("stores")["stores"]
            assert rows and not any(r["fenced"] for r in rows)
            for k in keys:
                t = NetTrials(srv0.url, exp_key=k, retries=0)
                t._insert_trial_docs(_mk_docs(t.new_trial_ids(1), k,
                                              [0.3]))
                t.refresh()
                assert sorted(d["tid"] for d in t.trials) == [0, 1, 2]
        finally:
            router.shutdown()
            srv0.shutdown()

    def test_failed_import_fails_over_to_dest_replica(self, tmp_path):
        """The destination primary dying mid-move is a failover, not an
        abort: the import lands on the promoted replica and the shrink
        completes with every tid intact."""
        import socket

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        dead_url = "http://127.0.0.1:%d" % sock.getsockname()[1]
        sock.close()
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        rp = ShardServer(str(tmp_path / "rp"), role="replica",
                         fsync="never")
        rp.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None},
                         "s1": {"primary": dead_url,
                                "replica": rp.url}},
                        retries=0, backoff=0.01)
        router.start()
        f0 = _counter("router.failovers")
        try:
            keys = [f"e{i}" for i in range(4)]
            for k in keys:
                t = NetTrials(srv0.url, exp_key=k, retries=0)
                t._insert_trial_docs(_mk_docs(t.new_trial_ids(2), k,
                                              [0.1, 0.2]))
            out = router._shard_remove_verb({"shard": "s0"})
            assert out["migrated"] == len(keys)
            with router._lock:
                assert list(router._map.shards) == ["s1"]
                assert router._map.shards["s1"]["primary"] == rp.url
            assert _counter("router.failovers") == f0 + 1
            for k in keys:
                t = RouterTrials(router.url, exp_key=k, retries=1,
                                 map_refresh_s=0.0)
                t.refresh()
                assert sorted(d["tid"] for d in t.trials) == [0, 1]
        finally:
            router.shutdown()
            srv0.shutdown(), rp.shutdown()

    def test_promotion_lifts_stale_fence(self, tmp_path):
        """A fence WAL-ships to the replica; if the primary dies before
        the cutover's outcome ships, the promoted replica would serve
        the store fenced forever.  The router's post-promotion
        reconciler lifts exactly that fence: the map still routes the
        key here, so the cutover died mid-flight."""
        p = ShardServer(str(tmp_path / "p"), role="primary",
                        fsync="never")
        p.start()
        r = ShardServer(str(tmp_path / "r"), role="replica",
                        fsync="never")
        r.start()
        p.attach_replica(r.url)
        t = NetTrials(p.url, exp_key="e0", retries=0)
        t._insert_trial_docs(_mk_docs(t.new_trial_ids(2), "e0",
                                      [0.1, 0.2]))
        _Rpc(p.url, "e0")("store_fence")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            rows = {x["exp_key"]: x
                    for x in _Rpc(r.url, "x")("stores")["stores"]}
            if rows.get("e0", {}).get("fenced"):
                break
            time.sleep(0.05)
        assert rows["e0"]["fenced"] and rows["e0"]["docs"] == 2

        # The primary dies with the cutover outcome unshipped.
        p._httpd.shutdown()
        p._httpd.server_close()

        router = Router({"s0": {"primary": p.url, "replica": r.url}},
                        retries=1, backoff=0.01)
        router.start()
        rc0 = _counter("router.fences_reconciled")
        try:
            rt = RouterTrials(router.url, exp_key="e0", retries=2,
                              map_refresh_s=0.0)
            rt.refresh()
            assert sorted(d["tid"] for d in rt.trials) == [0, 1]
            assert _counter("router.fences_reconciled") == rc0 + 1
            # The store is back in service: mutations flow.
            rt._insert_trial_docs(_mk_docs(rt.new_trial_ids(1), "e0",
                                           [0.3]))
            rows = {x["exp_key"]: x
                    for x in _Rpc(r.url, "x")("stores")["stores"]}
            assert not rows["e0"]["fenced"]
        finally:
            router.shutdown()
            p.shutdown(), r.shutdown()

    def test_store_fence_lift_verb_and_wal_replay(self, tmp_path):
        """``store_fence lift=True`` reopens a fenced store, and the
        lift is WAL-durable: a restarted shard replays to UNFENCED."""
        root = str(tmp_path / "p")
        srv = ShardServer(root, role="primary", fsync="never")
        srv.start()
        t = NetTrials(srv.url, exp_key="e0", retries=0)
        t._insert_trial_docs(_mk_docs(t.new_trial_ids(2), "e0",
                                      [0.1, 0.2]))
        rpc = _Rpc(srv.url, "e0")
        rpc("store_fence")
        with pytest.raises(ShardFenced):
            t._insert_trial_docs(_mk_docs([2], "e0", [0.3]))
        out = rpc("store_fence", lift=True)
        assert out["lifted"]
        t._insert_trial_docs(_mk_docs(t.new_trial_ids(1), "e0", [0.3]))
        srv.shutdown()

        srv2 = ShardServer(root, role="primary", fsync="never")
        srv2.start()
        try:
            t2 = NetTrials(srv2.url, exp_key="e0", retries=0)
            t2.refresh()
            assert sorted(d["tid"] for d in t2.trials) == [0, 1, 2]
            # Replay landed unfenced: mutations flow immediately.
            t2._insert_trial_docs(_mk_docs(t2.new_trial_ids(1), "e0",
                                           [0.4]))
        finally:
            srv2.shutdown()


# ---------------------------------------------------------------------------
# satellite regression: parked long-poll claimants across a fence
# ---------------------------------------------------------------------------


class TestParkedClaimAcrossFence:
    def test_fence_wakes_parked_claim_with_typed_redirect(self, tmp_path):
        """A ``reserve(wait_s=8)`` parked on an empty shard must wake
        the moment the shard fences — surfacing the typed redirect in
        well under its wait budget, not dozing out the cutover window."""
        srv = ShardServer(str(tmp_path / "p"), role="primary",
                          fsync="never")
        srv.start()
        try:
            nt = NetTrials(srv.url, exp_key="e1", refresh=False)
            got = {}

            def claimant():
                t0 = time.monotonic()
                try:
                    nt.reserve("w0", wait_s=8.0)
                except ShardFenced as e:
                    got["err"] = e
                got["s"] = time.monotonic() - t0

            p0 = _counter("store.longpoll.parked")
            th = threading.Thread(target=claimant)
            th.start()
            assert _wait_counter("store.longpoll.parked", p0 + 1) == p0 + 1
            f0 = _counter("shard.fences")
            _Rpc(srv.url, "e1")("fence")
            th.join(timeout=10)
            assert not th.is_alive()
            assert isinstance(got.get("err"), ShardFenced)
            assert got["s"] < 5.0, "claimant dozed out its wait budget"
            assert _counter("shard.fences") == f0 + 1
        finally:
            srv.shutdown()

    def test_routed_claimant_rides_redirect_across_live_rebalance(
            self, tmp_path, monkeypatch):
        """The full satellite: a ROUTED claimant parked mid-rebalance is
        fenced awake, follows the typed redirect to the new primary,
        re-parks there, and completes its claim from the first doc
        inserted after the cutover — no client-side polling, no lost
        wait budget."""
        old = ShardServer(str(tmp_path / "old"), role="primary",
                          fsync="never")
        new = ShardServer(str(tmp_path / "new"), role="replica",
                          fsync="never")
        old.start(), new.start()
        router = Router({"s0": {"primary": old.url, "replica": None}},
                        retries=1, backoff=0.01)
        router.start()
        try:
            t = RouterTrials(router.url, exp_key="e1", retries=1,
                             map_refresh_s=0.0)
            got = {}

            def claimant():
                got["doc"] = t.reserve("w0", wait_s=15.0)
                got["t"] = time.monotonic()

            p0 = _counter("store.longpoll.parked")
            r0 = _counter("netstore.client.redirects")
            th = threading.Thread(target=claimant)
            th.start()
            assert _wait_counter("store.longpoll.parked", p0 + 1) == p0 + 1

            out = _Rpc(router.url, "__ctl__")(
                "rebalance", shard="s0", url=new.url)
            assert out["primary"] == new.url
            t_cut = time.monotonic()

            # Feed the re-parked claimant through the router: the doc
            # lands on the NEW primary and the claim surfaces promptly.
            feeder = RouterTrials(router.url, exp_key="e1", retries=1,
                                  map_refresh_s=0.0)
            feeder._insert_trial_docs(_mk_docs([0], "e1", [0.5]))
            th.join(timeout=15)
            assert not th.is_alive()
            assert got["doc"] is not None and got["doc"]["tid"] == 0
            assert got["t"] - t_cut < 10.0
            assert _counter("netstore.client.redirects") >= r0 + 1
            # The claim was served by the new primary, not the fenced
            # old one.
            assert t._rpc.url == new.url
        finally:
            router.shutdown()
            old.shutdown(), new.shutdown()


# ---------------------------------------------------------------------------
# graceful degradation: shed directive + typed Backpressure clients
# ---------------------------------------------------------------------------


class TestBackpressure:
    def test_shed_refuses_producers_drain_keeps_flowing(self, tmp_path,
                                                        monkeypatch):
        """An armed shed refuses admissions with typed Backpressure
        (carrying the server's own retry_after_s) while reserve /
        write_result — the verbs that DRAIN load — keep working."""
        srv = ShardServer(str(tmp_path / "p"), role="primary",
                          fsync="never")
        srv.start()
        try:
            nt = NetTrials(srv.url, exp_key="e1", refresh=False,
                           backpressure_retries=0)
            nt._insert_trial_docs(_mk_docs([0], "e1", [0.5]))
            _Rpc(srv.url, "e1")("shed", level=1.0, ttl_s=30.0,
                                retry_after_s=0.25)
            b0 = _counter("backpressure.shed")
            with pytest.raises(Backpressure) as ei:
                nt._insert_trial_docs(_mk_docs([1], "e1", [0.6]))
            assert ei.value.retry_after_s == 0.25
            assert _counter("backpressure.shed") == b0 + 1
            # Drain verbs flow: in-flight work completes under shed.
            doc = nt.reserve("w0")
            assert doc is not None
            assert nt.write_result(_complete(doc, 1.0), owner="w0")
            # A refused admission left no durable trace.
            nt.refresh()
            assert [d["tid"] for d in nt._dynamic_trials] == [0]
        finally:
            srv.shutdown()

    def test_client_honors_retry_after_without_burning_transport(
            self, tmp_path):
        """A shed client sleeps the server-named retry_after_s and
        re-sends the SAME request; when the shed lifts, the call lands —
        with zero transport retries consumed."""
        srv = ShardServer(str(tmp_path / "p"), role="primary",
                          fsync="never")
        srv.start()
        try:
            nt = NetTrials(srv.url, exp_key="e1", retries=0,
                           refresh=False)
            _Rpc(srv.url, "e1")("shed", level=1.0, ttl_s=30.0,
                                retry_after_s=0.05)
            h0 = _counter("backpressure.client.honored")
            t0 = _counter("netstore.rpc.retry")
            done = {}

            def producer():
                done["tids"] = nt._insert_trial_docs(
                    _mk_docs([0], "e1", [0.5]))

            th = threading.Thread(target=producer)
            th.start()
            assert _wait_counter("backpressure.client.honored",
                                 h0 + 1) >= h0 + 1
            _Rpc(srv.url, "e1")("shed", level=0.0)   # recover
            th.join(timeout=15)
            assert not th.is_alive()
            assert done["tids"] == [0]
            assert _counter("netstore.rpc.retry") == t0, \
                "backpressure honor must not burn the transport budget"
        finally:
            srv.shutdown()

    def test_shed_ttl_fails_open(self, tmp_path, monkeypatch):
        """A dead autoscaler cannot throttle the fleet forever: the
        directive expires at its TTL and admissions resume."""
        srv = ShardServer(str(tmp_path / "p"), role="primary",
                          fsync="never")
        srv.start()
        try:
            nt = NetTrials(srv.url, exp_key="e1", refresh=False,
                           backpressure_retries=0)
            _Rpc(srv.url, "e1")("shed", level=1.0, ttl_s=0.15,
                                retry_after_s=0.05)
            time.sleep(0.3)
            assert nt._insert_trial_docs(
                _mk_docs([0], "e1", [0.5])) == [0]
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# the autoscaler: decision table against a real fleet, WAL decision log
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestAutoscalerControlLoop:
    def test_decision_table_end_to_end_with_wal_replay(self, tmp_path,
                                                       monkeypatch):
        """One deterministic pass through the whole table against a real
        one-shard fleet: scale_up on burn (stores migrate to the spawned
        shard), cooldown hold, shed at the capacity wall, recover when
        burn subsides, calm-gated scale_down back to one shard — with
        zero lost tids throughout and every decision replayed from the
        WAL by a fresh control plane."""
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None}},
                        retries=1, backoff=0.01)
        router.start()
        spawner = LocalSpawner(str(tmp_path / "auto"))
        a = Autoscaler(router, spawner=spawner,
                       wal_dir=str(tmp_path / "decisions"),
                       interval_s=0.05, cooldown_s=10.0,
                       min_shards=1, max_shards=2, calm_ticks=3)
        router.attach_autoscaler(a)
        try:
            keys = ["e0", "e1"]          # e1 moves to auto0, e0 stays
            for k in keys:
                t = RouterTrials(router.url, exp_key=k, retries=1,
                                 map_refresh_s=0.0)
                t._insert_trial_docs(_mk_docs([0, 1], k, [0.1, 0.2]))

            # Burn over threshold with headroom: scale_up.
            d = a.tick(signals={"burn": 2.0, "n_shards": 1,
                                "loads": {"s0": 4},
                                "firing": ["suggest_p95"]}, now=100.0)
            assert d["action"] == "scale_up" and d["ok"] is True
            assert d["shard"] == "auto0"
            with router._lock:
                assert set(router._map.shards) == {"s0", "auto0"}
            assert _counter("autoscale.scale_ups") >= 1

            # Still burning with headroom but inside cooldown: hold
            # (flap damping), never a back-to-back scale_up.
            d = a.tick(signals={"burn": 2.0, "n_shards": 1,
                                "loads": {}}, now=101.0)
            assert d["action"] == "hold"
            assert "cooldown" in d["reason"]

            # Burning with NO headroom (max_shards reached): shed — and
            # the directive lands on every primary in the map.
            d = a.tick(signals={"burn": 4.0, "n_shards": 2,
                                "loads": {}}, now=120.0)
            assert d["action"] == "shed" and d["ok"] is True
            assert d["level"] == 0.9     # capped, scaled with burn
            assert srv0._shed is not None
            assert srv0._shed["level"] == 0.9
            assert spawner._live["auto0"]._shed is not None

            # Burn subsides: recover lifts the shed fleet-wide.
            d = a.tick(signals={"burn": 0.1, "n_shards": 2,
                                "loads": {}}, now=121.0)
            assert d["action"] == "recover" and d["ok"] is True
            assert srv0._shed is None
            assert spawner._live["auto0"]._shed is None

            # Calm must SUSTAIN before the fleet shrinks (the recover
            # tick above was calm tick #1): one more holds, the third
            # drains the least-loaded shard.
            calm = {"burn": 0.0, "n_shards": 2,
                    "loads": {"s0": 4, "auto0": 1}}
            assert a.tick(signals=calm, now=140.0)["action"] == "hold"
            d = a.tick(signals=calm, now=141.0)
            assert d["action"] == "scale_down" and d["ok"] is True
            assert d["shard"] == "auto0"     # least-loaded victim
            with router._lock:
                assert list(router._map.shards) == ["s0"]
            assert "auto0" not in spawner._live

            # Zero lost/duplicated across the whole grow/shrink story.
            for k in keys:
                t = RouterTrials(router.url, exp_key=k, retries=1,
                                 map_refresh_s=0.0)
                t.refresh()
                tids = [d_["tid"] for d_ in t.trials]
                assert sorted(tids) == [0, 1]
                assert len(tids) == len(set(tids))

            # The decision log explains every topology change — and a
            # fresh control plane replays it from the WAL.
            acts = [d_["action"] for d_ in a.status()["decisions"]]
            assert acts == ["scale_up", "shed", "recover", "scale_down"]
            a.stop()
            a2 = Autoscaler(router, wal_dir=str(tmp_path / "decisions"))
            replayed = [d_["action"] for d_ in a2.status()["decisions"]]
            assert replayed == acts
            assert a2._seq == 4
            a2.stop()

            # status() rides the router's /metrics payload.
            snap = router.metrics_payload()
            assert "autoscale" in snap
            assert snap["autoscale"]["min_shards"] == 1
        finally:
            a.stop()
            spawner.close()
            router.shutdown()
            srv0.shutdown()

    def test_degradation_only_mode_without_spawner(self, tmp_path):
        """No spawner (quota wall from tick one): burn sheds instead of
        failing, and the loop thread survives a sick tick."""
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None}},
                        retries=0, backoff=0.01)
        a = Autoscaler(router, interval_s=0.05, min_shards=1,
                       max_shards=8)
        try:
            d = a.tick(signals={"burn": 1.5, "n_shards": 1, "loads": {}},
                       now=0.0)
            assert d["action"] == "shed" and d["ok"] is True
            # The live loop keeps breathing: scrape against the real
            # fleet (no synthetic signals) decides hold/recover without
            # raising.
            a.start()
            deadline = time.monotonic() + 5
            while (_counter("autoscale.ticks") < 2
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert _counter("autoscale.ticks") >= 2
            assert a.status()["running"]
        finally:
            a.stop()
            router.shutdown()
            srv0.shutdown()


# ---------------------------------------------------------------------------
# single-flight promotion: two routers race one SIGKILLed primary
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestSingleFlightPromotion:
    def test_two_routers_one_kill_exactly_one_promotion(self, tmp_path,
                                                        monkeypatch):
        """Two independent routers front the same shard.  The primary is
        SIGKILLed; both routers observe the death concurrently and race
        ``promote`` at the shared replica.  The epoch guard + idempotent
        role transition make the promotion single-flight — exactly one
        actual transition — and both clients' retried verbs land
        exactly once on the survivor."""
        from test_torch_service_fleet import _launch_shard, _stop

        rp = ShardServer(str(tmp_path / "r"), role="replica",
                         fsync="never")
        rp.start()
        pp, purl = _launch_shard(
            ["--wal-dir", str(tmp_path / "p"), "--role", "primary",
             "--replicate-to", rp.url])
        shards = {"s0": {"primary": purl, "replica": rp.url}}
        r1 = Router(shards, retries=1, backoff=0.01)
        r2 = Router(shards, retries=1, backoff=0.01)
        r1.start(), r2.start()
        try:
            seed = RouterTrials(r1.url, exp_key="e1", retries=1)
            tids = seed.new_trial_ids(2)
            seed._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2]))
            _catch_up(purl, rp.url)

            p0 = _counter("shard.promotions")
            os.kill(pp.pid, signal.SIGKILL)
            assert pp.wait(timeout=10) == -signal.SIGKILL

            barrier = threading.Barrier(2)
            out = [None, None]

            def race(i, url):
                t = RouterTrials(url, exp_key="e1", retries=1)
                barrier.wait()
                out[i] = t.new_trial_ids(1)[0]

            ts = [threading.Thread(target=race, args=(0, r1.url)),
                  threading.Thread(target=race, args=(1, r2.url))]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=30)
            assert all(not th.is_alive() for th in ts)

            # Both clients were served... by exactly ONE promotion.
            assert sorted(out) == [2, 3]     # distinct: exactly-once
            assert _counter("shard.promotions") == p0 + 1
            assert rp.role == "primary"
            for r in (r1, r2):
                with r._lock:
                    assert r._map.shards["s0"]["primary"] == rp.url

            # A laggard with a STALE epoch cannot promote backwards.
            st0 = _counter("shard.promote.stale")
            out2 = _Rpc(rp.url, "e1")("promote", epoch=0)
            assert out2.get("stale") is True
            assert _counter("shard.promote.stale") == st0 + 1

            # Nothing was lost across the kill.
            t = RouterTrials(r1.url, exp_key="e1", retries=1)
            t.refresh()
            seen = [d["tid"] for d in t.trials]
            assert sorted(seen) == [0, 1]
            assert len(seen) == len(set(seen))
        finally:
            r1.shutdown(), r2.shutdown()
            _stop(pp)
            rp.shutdown()


# ---------------------------------------------------------------------------
# replica chains: P -> R1 -> R2, byte-identity at every hop
# ---------------------------------------------------------------------------


class TestReplicaChain:
    def test_two_hop_chain_byte_identity_and_midchain_resync(
            self, tmp_path, monkeypatch):
        """R1 ships onward to R2 (the primary's fan-out stays O(1)); a
        LATE second hop resyncs from the middle of the chain, not the
        primary; and after the primary dies, the promoted R1 keeps the
        chain flowing.  Byte-identity (equal state hash at equal seq)
        holds at every hop at every checkpoint."""
        p = ShardServer(str(tmp_path / "p"), role="primary",
                        fsync="never")
        r1 = ShardServer(str(tmp_path / "r1"), role="replica",
                         fsync="never")
        r2 = ShardServer(str(tmp_path / "r2"), role="replica",
                         fsync="never")
        p.start(), r1.start(), r2.start()
        try:
            p.attach_replica(r1.url)
            nt = NetTrials(p.url, exp_key="e1", refresh=False)
            tids = nt.new_trial_ids(4)
            nt._insert_trial_docs(_mk_docs(tids, "e1",
                                           [0.1, 0.2, 0.3, 0.4]))
            assert p._shippers[0].flush()

            # Late joiner attaches to R1 — the resync (snapshot install)
            # comes from the MIDDLE hop; the primary never sees R2.
            rs0 = _counter("replica.resyncs")
            r1.attach_replica(r2.url)
            assert r1._shippers[0].flush()
            assert _counter("replica.resyncs") >= rs0 + 1
            assert not any(sh.url == r2.url for sh in p._shippers)
            s_p, s_r1, s_r2 = (_scrub(u) for u in
                               (p.url, r1.url, r2.url))
            assert s_p == s_r1 == s_r2   # byte-identical through 2 hops

            # Tail records flow the whole chain: every applied wal_ship
            # re-appends on R1, which fans onward.
            for _ in range(4):
                doc = nt.reserve("w0")
                assert nt.write_result(_complete(doc, 1.0), owner="w0")
            assert p._shippers[0].flush()
            assert r1._shippers[0].flush()
            s_p, s_r1, s_r2 = (_scrub(u) for u in
                               (p.url, r1.url, r2.url))
            assert s_p == s_r1 == s_r2
            assert s_p[0] > 0

            # Both downstream hops fence client mutations.
            for url in (r1.url, r2.url):
                with pytest.raises(RuntimeError):
                    NetTrials(url, exp_key="e1",
                              refresh=False).new_trial_ids(1)

            # Primary dies; promoted R1 serves AND keeps shipping to R2.
            p.shutdown()
            _Rpc(r1.url, "e1")("promote", epoch=1)
            nt2 = NetTrials(r1.url, exp_key="e1", refresh=False)
            more = nt2.new_trial_ids(2)
            nt2._insert_trial_docs(_mk_docs(more, "e1", [0.5, 0.6]))
            assert r1._shippers[0].flush()
            s_r1, s_r2 = _scrub(r1.url), _scrub(r2.url)
            assert s_r1 == s_r2
            nt2.refresh()
            seen = [d["tid"] for d in nt2._dynamic_trials]
            assert sorted(seen) == [0, 1, 2, 3, 4, 5]
            assert len(seen) == len(set(seen))
        finally:
            for s in (p, r1, r2):
                s.shutdown()


# ---------------------------------------------------------------------------
# seeded long schedule: elastic churn under load (-m slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.chaos
class TestElasticChurnLong:
    def test_seeded_autoscale_churn_zero_lost(self, tmp_path,
                                              monkeypatch):
        """Seeded burn schedule drives the autoscaler through repeated
        grow / shed / recover / shrink rounds while clients keep
        inserting across eight stores.  Invariant after every round and
        at the end: zero lost, zero duplicated tids; the decision log
        replays to the same sequence."""
        import random

        rng = random.Random(20260807)
        srv0 = ShardServer(str(tmp_path / "s0"), role="primary",
                           fsync="never")
        srv0.start()
        router = Router({"s0": {"primary": srv0.url, "replica": None}},
                        retries=1, backoff=0.01)
        router.start()
        spawner = LocalSpawner(str(tmp_path / "auto"))
        a = Autoscaler(router, spawner=spawner,
                       wal_dir=str(tmp_path / "decisions"),
                       interval_s=0.05, cooldown_s=0.0,
                       min_shards=1, max_shards=3, calm_ticks=2)
        keys = [f"e{i}" for i in range(8)]
        inserted = {k: 0 for k in keys}
        clients = {k: RouterTrials(router.url, exp_key=k, retries=2,
                                   map_refresh_s=0.0) for k in keys}
        try:
            now = 1000.0
            for rnd in range(24):
                burn = rng.choice([0.0, 0.0, 0.2, 1.5, 2.5, 5.0])
                now += 1.0
                with router._lock:
                    n = len(router._map.shards)
                a.tick(signals={"burn": burn, "n_shards": n,
                                "loads": {}}, now=now)
                # Traffic between control decisions; a shed round makes
                # producers wait it out via the honored retry path.
                for k in rng.sample(keys, 3):
                    t = clients[k]
                    tid = t.new_trial_ids(1)[0]
                    assert tid == inserted[k]
                    t._insert_trial_docs(_mk_docs(
                        [tid], k, [0.1 * (tid + 1)]))
                    inserted[k] += 1
                if a._shed_level > 0.0 and rng.random() < 0.5:
                    a.tick(signals={"burn": 0.0, "n_shards": n,
                                    "loads": {}}, now=now + 0.5)
                if rnd % 6 == 5:         # periodic audit
                    for k in keys:
                        clients[k].refresh()
                        tids = [d["tid"] for d in clients[k].trials]
                        assert sorted(tids) == list(range(inserted[k]))
            # Lift any trailing shed, then the final audit.
            if a._shed_level > 0.0:
                a.tick(signals={"burn": 0.0, "n_shards": 1,
                                "loads": {}}, now=now + 10.0)
            for k in keys:
                clients[k].refresh()
                tids = [d["tid"] for d in clients[k].trials]
                assert sorted(tids) == list(range(inserted[k]))
                assert len(tids) == len(set(tids))
            # Decision log replay agrees with the live control plane.
            a.stop()
            a2 = Autoscaler(router, wal_dir=str(tmp_path / "decisions"))
            assert a2._seq == a._seq
            assert ([d["action"] for d in a2.status()["decisions"]]
                    == [d["action"] for d in a.status()["decisions"]])
            a2.stop()
        finally:
            a.stop()
            spawner.close()
            router.shutdown()
            srv0.shutdown()
