"""The PyTorch port's RAM store and write-ahead log against hyperopt_tpu's.

* **Against JAX on the same inputs**: ``MemTrials.history(cs)`` and
  ``inflight(cs)`` equal the JAX ``MemTrials``'s arrays on seeded docs
  (NaN and inf losses, failed trials, conditional parameters, growth past
  several capacities); ``state_bytes()`` equals JAX's after the same verb
  sequence under the same ``now_override``.
* **WAL interop**: a WAL directory a JAX ``ServiceServer`` wrote recovers
  in the port's to the same ``state_bytes()``, and the reverse, in
  snapshot formats 1 and 2 and with a torn tail (store verbs only: a
  domain pickled by one package is not the other's).
* **The verb catalogs**: ``_MUTATING_VERBS``, ``_IDEMPOTENT_VERBS`` and
  ``_CONTROL_VERBS`` equal the JAX module's, and every idempotent verb,
  ``store_fence`` and ``store_import`` included, leaves ``state_dict()``
  the same when applied twice under a pinned clock.
* **The columns feed the resident ring**: a server-side suggest after k
  more results uploads k rows, and a column buffer regrown between two
  suggests leaves no stale row in the ring.
* **Mirrors** on the port of ``tests/test_service.py::TestMemTrials`` and
  ``tests/test_wire.py::TestFetchSince``, ``TestColumnarSnapshot`` and
  ``TestHotColumns``.  The JAX environment switches are the port's
  arguments here (``MemTrials(columns=)``, ``wire.set_mode``).

Every server binds port 0 and is shut down by the test; every client has
a timeout of its own.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import base, history, hp, rand, tpe, wire
from hyperopt_tpu_torch.base import (JOB_STATE_DONE, JOB_STATE_NEW,
                                     JOB_STATE_RUNNING, STATUS_OK)
from hyperopt_tpu_torch.exceptions import InvalidTrial, QuotaExceeded
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.parallel import netstore
from hyperopt_tpu_torch.parallel.netstore import NetTrials
from hyperopt_tpu_torch.service import MemTrials, Tenant, TenantTable
from hyperopt_tpu_torch.service import wal as wal_mod
from hyperopt_tpu_torch.service.server import ServiceServer
from hyperopt_tpu_torch.space import compile_space

CPU = "cpu"
TIMEOUT = 20.0


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


def _counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


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


def _nt(url, **kw):
    kw.setdefault("timeout", TIMEOUT)
    return NetTrials(url, **kw)


def _jax_service():
    from hyperopt_tpu.service import store as jstore
    from hyperopt_tpu.service import server as jserver

    return jstore, jserver


# ---------------------------------------------------------------------------
# mirrors: tests/test_service.py::TestMemTrials
# ---------------------------------------------------------------------------


class TestMemTrials:
    def test_insert_refresh_and_duplicate_guard(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0, 1], "e", [0.1, 0.2]))
        mt.refresh()
        assert [d["tid"] for d in mt._dynamic_trials] == [0, 1]
        with pytest.raises(InvalidTrial):
            mt._insert_trial_docs(_mk_docs([1], "e", [0.3]))

    def test_new_trial_ids_monotonic_past_allocations(self):
        mt = MemTrials(exp_key="e")
        assert mt.new_trial_ids(2) == [0, 1]
        # allocated-but-not-inserted ids are never reissued
        assert mt.new_trial_ids(1) == [2]
        mt._insert_trial_docs(_mk_docs([7], "e", [0.5]))
        assert mt.new_trial_ids(1) == [8]

    def test_claim_lifecycle_and_fencing(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0, 1], "e", [0.1, 0.2]))
        doc = mt.reserve("w0")
        assert doc["tid"] == 0 and doc["state"] == JOB_STATE_RUNNING
        assert mt.heartbeat(doc, owner="w0")
        assert not mt.heartbeat(doc, owner="imposter")   # fenced
        assert not mt.write_result(_complete(dict(doc), 1.0),
                                   owner="imposter")     # fenced
        assert mt.write_result(_complete(dict(doc), 1.0), owner="w0")
        mt.refresh()
        assert mt._by_tid[0]["state"] == JOB_STATE_DONE
        # second reserve gets the remaining NEW trial, not the done one
        assert mt.reserve("w1")["tid"] == 1

    def test_requeue_stale_uses_override_clock(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0], "e", [0.1]))
        mt.now_override = 1000.0
        doc = mt.reserve("w0")
        assert doc["book_time"] == 1000.0
        mt.now_override = 1100.0
        assert mt.requeue_stale(timeout=50.0) == 1
        mt.refresh()
        assert mt._by_tid[0]["state"] == JOB_STATE_NEW
        assert 0 not in mt._claims

    def test_state_roundtrip_is_byte_identical(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0, 1, 2], "e", [0.1, 0.2, 0.3]))
        mt.now_override = 500.0
        doc = mt.reserve("w0")
        mt.write_result(_complete(dict(doc), 2.5), owner="w0")
        mt.reserve("w1")
        mt.put_domain_blob(b"\x00blob")
        other = MemTrials(exp_key="e")
        other.load_state(json.loads(json.dumps(mt.state_dict())))
        assert other.state_bytes() == mt.state_bytes()
        # the claim table survives (claims outlive completion, filestore
        # parity): w0 keeps tid 0, w1 still owns the RUNNING tid 1
        assert other._claims == {0: "w0", 1: "w1"}


# ---------------------------------------------------------------------------
# against JAX: columnar history, inflight, state bytes
# ---------------------------------------------------------------------------


def _cond_space(hp_mod):
    return {"x": hp_mod.uniform("x", -5, 5),
            "lr": hp_mod.loguniform("lr", -6, 0),
            "c": hp_mod.choice("c", [{"a": hp_mod.normal("a", 0, 1)},
                                     {"k": hp_mod.quniform("k", 0, 8, 1)}])}


def _seeded_docs(n, seed):
    """``n`` docs over the conditional space, with their fates: done with
    a finite, NaN or inf loss, failed, or left NEW/RUNNING."""
    rng = np.random.default_rng(seed)
    dom = base.Domain(lambda d: 0.0, _cond_space(hp))
    dom.cs.device = CPU
    t = base.Trials(exp_key="e")
    docs = rand.suggest(list(range(n)), dom, t, int(rng.integers(2 ** 31)))
    docs = json.loads(json.dumps(docs))
    fates = []
    for d in docs:
        r = rng.random()
        if r < 0.6:
            fates.append(("ok", float(rng.normal())))
        elif r < 0.67:
            fates.append(("ok", math.nan))
        elif r < 0.74:
            fates.append(("ok", math.inf))
        elif r < 0.84:
            fates.append(("fail", None))
        else:
            fates.append(("live", None))
    return docs, fates


def _drive_store(mt, docs, fates, chunk, cs, snaps):
    """Insert ``docs`` in chunks, claim and land each chunk's fates, and
    record ``history``/``inflight`` after every chunk (the buffers grow
    across several capacities)."""
    mt.now_override = 2000.0
    for i in range(0, len(docs), chunk):
        part = [dict(d) for d in docs[i:i + chunk]]
        mt._insert_trial_docs(json.loads(json.dumps(part)))
        for d, (fate, loss) in zip(part, fates[i:i + chunk]):
            got = mt.reserve("w")
            assert got["tid"] == d["tid"]
            if fate == "live":
                continue
            got["state"] = JOB_STATE_DONE
            got["result"] = ({"status": "fail"} if fate == "fail"
                             else {"status": STATUS_OK, "loss": loss})
            assert mt.write_result(got, owner="w")
        first = {k: np.array(v) for k, v in mt.history(cs).items()}
        again = {k: np.array(v) for k, v in mt.history(cs).items()}
        snaps.append((first, again,
                      tuple(np.array(a) for a in mt.inflight(cs))))


class TestAgainstJax:
    def test_history_and_inflight_equal_jax(self):
        from hyperopt_tpu import hp as jhp
        from hyperopt_tpu.space import compile_space as jcompile

        jstore, _ = _jax_service()
        docs, fates = _seeded_docs(600, 3)
        mine, theirs = [], []
        _drive_store(MemTrials(exp_key="e"), docs, fates, 75,
                     compile_space(_cond_space(hp)), mine)
        _drive_store(jstore.MemTrials(exp_key="e"), docs, fates, 75,
                     jcompile(_cond_space(jhp)), theirs)
        assert len(mine) == len(theirs) == 8
        n_done = 0
        for (hm, hm2, im), (_, hj, ij) in zip(mine, theirs):
            # The port's first call after a growing append equals its
            # second and JAX's second: the JAX package's first call after
            # a growth returns the old buffers (ROADMAP Queue 3), so JAX
            # is compared once its columns have caught up.
            for k in ("vals", "active", "loss", "ok", "tids"):
                assert hm[k].dtype == hj[k].dtype, k
                assert np.array_equal(hm[k], hj[k], equal_nan=True), k
                assert np.array_equal(hm2[k], hj[k], equal_nan=True), k
            for a, b in zip(im, ij):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            n_done = len(hm["tids"])
        # the columns grew past several capacities (64 → 128 → ...)
        assert n_done > 4 * 64
        assert np.isnan(mine[-1][0]["loss"]).sum() == 0   # NaN → +inf
        assert (~mine[-1][0]["ok"]).sum() > 0

    def test_first_history_after_a_growing_append_is_current(self):
        """The append that regrows the columns serves the rows it just
        appended, as the base class's doc walk does."""
        from hyperopt_tpu import hp as jhp
        from hyperopt_tpu.space import compile_space as jcompile

        jstore, _ = _jax_service()
        cs, jcs = compile_space({"x": hp.uniform("x", -5, 5)}), \
            jcompile({"x": jhp.uniform("x", -5, 5)})
        mt, jmt = MemTrials(exp_key="e"), jstore.MemTrials(exp_key="e")
        grown = 0
        for i in range(0, 300, 25):
            for store in (mt, jmt):
                store._insert_trial_docs([_complete(d, d["tid"] * 0.5)
                                          for d in _mk_docs(
                                              range(i, i + 25), "e",
                                              [0.01 * t for t in
                                               range(i, i + 25)])])
            cap = None if mt._col is None else len(mt._col["tids"])
            got = mt.history(cs)
            grown += cap is not None and len(mt._col["tids"]) > cap
            ref = base.Trials.history(mt, cs)
            jmt.history(jcs)
            jref = jmt.history(jcs)
            for k in ("vals", "active", "loss", "ok", "tids"):
                assert np.array_equal(got[k], ref[k], equal_nan=True), k
                assert np.array_equal(got[k], jref[k], equal_nan=True), k
        assert grown >= 2

    def test_state_bytes_equal_jax_after_the_same_verbs(self):
        jstore, _ = _jax_service()

        def drive(mt):
            mt.now_override = 1000.0
            mt._insert_trial_docs(_mk_docs([0, 1, 2, 3], "e",
                                           [0.1, 0.2, 0.3, 0.4]))
            a = mt.reserve("w0")
            b = mt.reserve("w1")
            mt.now_override = 1003.0
            assert mt.heartbeat(dict(a), owner="w0")
            assert mt.write_result(_complete(dict(a), 1.5), owner="w0")
            mt.now_override = 1100.0
            assert mt.requeue_stale(30.0) == 1          # b went silent
            mt.reserve("w2")
            mt.put_domain_blob(b"\x00dom")
            mt.attachments["meta"] = {"k": [1, 2.5]}
            mt.new_trial_ids(3)
            mt.fence()
            assert b["tid"] == 1
            return mt.state_bytes()

        assert drive(MemTrials(exp_key="e")) \
            == drive(jstore.MemTrials(exp_key="e"))


# ---------------------------------------------------------------------------
# WAL interop both ways, snapshot formats 1 and 2, torn tail
# ---------------------------------------------------------------------------


def _store_verbs(url, jax_client):
    """Store verbs only, through one package's client: inserts, claims,
    heartbeats, results, a requeue, attachments and a fence."""
    if jax_client:
        from hyperopt_tpu.parallel.netstore import NetTrials as NT
        from hyperopt_tpu.parallel.netstore import _Rpc as Rpc
    else:
        NT, Rpc = NetTrials, netstore._Rpc
    nt = NT(url, exp_key="e1", token="t", timeout=TIMEOUT)
    tids = nt.new_trial_ids(5)
    nt._insert_trial_docs(_mk_docs(tids, "e1", [0.1, 0.2, 0.3, 0.4, 0.5]))
    d0, d1 = nt.reserve("w0"), nt.reserve("w1")
    assert nt.heartbeat(d0, owner="w0")
    assert nt.write_result(_complete(dict(d0), 0.25), owner="w0")
    assert nt.requeue_stale(-5.0) == 1                  # d1 back to NEW
    d2 = nt.reserve("w2")
    assert nt.write_result(_complete(dict(d2), 1.5), owner="w2")
    nt.reserve("w3")                                    # left RUNNING
    nt.attachments["meta"] = {"k": [1, 2.5]}
    other = NT(url, exp_key="e2", token="t", timeout=TIMEOUT)
    other._insert_trial_docs(_mk_docs(other.new_trial_ids(2), "e2",
                                      [0.7, 0.8]))
    Rpc(url, "e2", token="t")("store_fence")
    return nt


def _finish(nt):
    doc = nt.reserve("w4")
    assert nt.write_result(_complete(dict(doc), 2.0), owner="w4")


class TestWalInterop:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    @pytest.mark.parametrize("mode", ["json", "binary"])
    def test_recovers_the_other_package_s_wal(self, tmp_path, monkeypatch,
                                              writer, mode):
        """Format 1 (``json``) or 2 (``binary``) snapshot plus a tail and
        a torn last line: the other package recovers to the writer's
        ``state_bytes()``."""
        _, jserver = _jax_service()
        monkeypatch.setenv("HYPEROPT_TPU_WIRE", mode)
        wire.set_mode(mode)
        wal_dir = str(tmp_path / "wal")
        mk = {"jax": jserver.ServiceServer, "port": ServiceServer}
        reader = "port" if writer == "jax" else "jax"
        srv = mk[writer](wal_dir, token="t")
        srv.start()
        try:
            nt = _store_verbs(srv.url, jax_client=writer == "jax")
            srv.snapshot()
            _finish(nt)
            want = srv.state_bytes()
        finally:
            srv.shutdown()
        with open(os.path.join(wal_dir, "snapshot.json")) as f:
            fmt = json.load(f).get("format", 1)
        assert fmt == (1 if mode == "json" else 2)
        with open(os.path.join(wal_dir, "wal.jsonl"), "a") as f:
            f.write('{"t": 1, "verb": "insert_docs", "re')   # torn tail
        srv2 = mk[reader](wal_dir, token="t")
        try:
            assert srv2.state_bytes() == want
        finally:
            srv2.shutdown()
        assert wal_mod.inspect(wal_dir)["torn_tail"] == 1

    def test_log_only_recovery_both_ways(self, tmp_path):
        """No snapshot: each package replays the other's whole log."""
        _, jserver = _jax_service()
        for writer, reader in ((jserver.ServiceServer, ServiceServer),
                               (ServiceServer, jserver.ServiceServer)):
            wal_dir = str(tmp_path / writer.__module__)
            srv = writer(wal_dir, token="t")
            srv.start()
            try:
                _finish(_store_verbs(srv.url, jax_client=False))
                want = srv.state_bytes()
            finally:
                srv.shutdown()
            srv2 = reader(wal_dir, token="t")
            try:
                assert srv2.state_bytes() == want
            finally:
                srv2.shutdown()


# ---------------------------------------------------------------------------
# the verb catalogs
# ---------------------------------------------------------------------------


class TestVerbCatalogs:
    def test_catalogs_are_the_jax_module_s(self):
        from hyperopt_tpu.parallel import netstore as jnet

        assert netstore._MUTATING_VERBS == jnet._MUTATING_VERBS
        assert netstore._IDEMPOTENT_VERBS == jnet._IDEMPOTENT_VERBS
        assert netstore._CONTROL_VERBS == jnet._CONTROL_VERBS
        assert netstore.StoreServer._READONLY_VERBS \
            == jnet.StoreServer._READONLY_VERBS
        assert not netstore._MUTATING_VERBS & netstore._IDEMPOTENT_VERBS

    def test_idempotent_verbs_converge_under_retry(self):
        """Mirror of ``test_lock_regressions.py::
        test_idempotent_verbs_converge_under_retry`` against the JAX
        package's live catalog (all 8 verbs): each applied twice under a
        pinned clock leaves ``state_dict()`` byte-identical to one
        application."""
        from hyperopt_tpu.parallel import netstore as jnet

        assert netstore._IDEMPOTENT_VERBS == jnet._IDEMPOTENT_VERBS
        assert len(jnet._IDEMPOTENT_VERBS) == 8

        def fresh(seed_claim=False):
            ft = MemTrials(exp_key="e")
            ft.now_override = 1000.0
            if seed_claim:
                ft._insert_trial_docs([base.new_trial_doc(0, "e", None)])
                ft.reserve("w0")
            return ft

        def assert_converges(ft, op):
            op(ft)
            first = json.dumps(ft.state_dict(), sort_keys=True)
            op(ft)
            assert json.dumps(ft.state_dict(), sort_keys=True) == first

        def att_del(ft):
            try:
                del ft.attachments["k"]
            except KeyError:
                pass

        donor = fresh(seed_claim=True)
        exported = donor.state_dict()
        doc = donor.export_docs()[0]
        ops = {
            "heartbeat": (True, lambda ft: ft.heartbeat(dict(doc),
                                                        owner="w0")),
            "requeue_stale": (True, lambda ft: ft.requeue_stale(-1.0)),
            "delete_all": (True, lambda ft: ft.delete_all()),
            "put_domain": (False, lambda ft: ft.put_domain_blob(b"dom")),
            "att_set": (False, lambda ft: ft.attachments.__setitem__(
                "k", b"v")),
            "att_del": (False, att_del),
            "store_fence": (True, lambda ft: ft.fence()),
            "store_import": (False, lambda ft: ft.load_state(
                dict(exported, fenced=False))),
        }
        assert set(ops) == set(jnet._IDEMPOTENT_VERBS)
        for verb, (claim, op) in ops.items():
            ft = fresh(seed_claim=claim)
            if verb == "att_del":
                ft.attachments["k"] = b"v"
            assert_converges(ft, op)
        # the fence's two other forms converge too
        for kw in ({"drop": True}, {"lift": True}):
            assert_converges(fresh(seed_claim=True),
                             lambda ft: ft.fence(**kw))


# ---------------------------------------------------------------------------
# the columns feed the resident ring: k rows per k results, no stale row
# ---------------------------------------------------------------------------


def _space():
    return {"x": hp.uniform("x", -5, 5), "y": hp.uniform("y", 0, 3)}


def _done_docs(tids, exp_key, rng):
    docs = []
    for tid in tids:
        d = base.new_trial_doc(tid, exp_key, None)
        x, y = float(rng.uniform(-5, 5)), float(rng.uniform(0, 3))
        d["misc"]["idxs"] = {"x": [tid], "y": [tid]}
        d["misc"]["vals"] = {"x": [x], "y": [y]}
        docs.append(_complete(d, (x - 1.0) ** 2 + y))
    return docs


def _ring(ft, cs, dev=CPU):
    return history._STORE[ft][(id(cs), str(torch.device(dev)))]


class TestColumnsFeedTheRing:
    def test_k_results_upload_k_rows_and_regrowth_leaves_no_stale_row(
            self, tmp_path):
        srv = ServiceServer(str(tmp_path / "wal"), token="t", fsync="never")
        srv.start()
        try:
            nt = _nt(srv.url, exp_key="e1", token="t")
            dom = base.Domain(lambda d: 0.0, _space())
            dom.cs.device = CPU
            nt.save_domain(dom)
            local = base.Trials(exp_key="e1")
            rng = np.random.default_rng(11)
            ft = srv._store("e1")
            p = dom.cs.n_params
            tid = 0

            def land(n):
                nonlocal tid
                docs = _done_docs(range(tid, tid + n), "e1", rng)
                tid += n
                nt._insert_trial_docs(json.loads(json.dumps(docs)))
                local.insert_trial_docs(json.loads(json.dumps(docs)))
                local.refresh()

            def both(seed):
                """Server-side suggest (its ring uploads returned) equal to
                the in-process one."""
                up0, hits0 = history.upload_bytes, history.append_hits
                got = nt.suggest(seed, new_ids=[10_000 + seed],
                                 insert=False)
                ups = (history.upload_bytes - up0,
                       history.append_hits - hits0)
                ref = tpe.suggest([10_000 + seed], dom, local, seed,
                                  verbose=False)
                assert got == json.loads(json.dumps(ref))
                return ups

            land(40)
            both(1)
            cap0 = len(ft._col["tids"])
            for k in (1, 5, 7):
                land(k)
                up, hits = both(1 + k)
                assert up == k * history._row_bytes(p)
                assert hits == 1
            # regrow the column buffers between two suggests
            cs = srv._domain_for(ft).cs          # the server's space
            views = ft.history(cs)
            old_tids = views["tids"].copy()
            land(cap0)
            up, _ = both(99)              # the columns regrow in there
            assert len(ft._col["tids"]) > cap0
            assert np.array_equal(views["tids"], old_tids)  # views intact
            assert up == cap0 * history._row_bytes(p)
            h = ft.history(cs)
            st = _ring(ft, cs)
            ref = history._padded_history(h, st.cap)
            for buf, want in zip(st.bufs, ref):
                got = buf.cpu().numpy()
                assert np.array_equal(got, want, equal_nan=True)
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# mirrors: tests/test_wire.py::TestFetchSince
# ---------------------------------------------------------------------------


class TestFetchSince:
    def test_first_fetch_is_full_then_deltas_are_exact(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0, 1], "e", [0.1, 0.2]))
        docs, cur, full = mt.docs_since(None)
        assert full and [d["tid"] for d in docs] == [0, 1]
        docs2, cur2, full2 = mt.docs_since(cur)
        assert docs2 == [] and not full2 and cur2 == cur
        mt._insert_trial_docs(_mk_docs([2], "e", [0.3]))
        claimed = mt.reserve("w0")
        docs3, cur3, full3 = mt.docs_since(cur)
        assert not full3 and cur3[1] > cur[1]
        assert sorted(d["tid"] for d in docs3) == [claimed["tid"], 2]

    def test_stale_or_foreign_cursor_costs_full_resend_never_a_gap(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0], "e", [0.1]))
        _, cur, _ = mt.docs_since(None)
        for bad in (["nope", 0], [cur[0] + 1, cur[1]], [cur[0], 10 ** 9],
                    [cur[0]], "cursor", 7):
            docs, _, full = mt.docs_since(bad)
            assert full and len(docs) == 1, bad
        mt.delete_all()
        mt._insert_trial_docs(_mk_docs([0], "e", [0.5]))
        docs, cur2, full = mt.docs_since(cur)
        assert full and cur2[0] != cur[0]

    def test_monotone_cursor_under_concurrent_inserts_and_requeues(self):
        mt = MemTrials(exp_key="e")
        mt.now_override = 0.0
        n_rows, errs = 120, []

        def writer():
            try:
                for i in range(n_rows):
                    mt._insert_trial_docs(_mk_docs([i], "e", [i * 0.01]))
                    if i % 3 == 0:
                        doc = mt.reserve(f"w{i}")
                        if doc is None:
                            continue
                        if i % 6 == 0:
                            mt.write_result(
                                _complete(dict(doc), float(i)),
                                owner=f"w{i}")
                        else:
                            mt.now_override += 1e6   # age the claim out
                            mt.requeue_stale(timeout=1.0)
            except Exception as e:      # surfaced after join
                errs.append(e)

        shadow, cursor = {}, None
        t = threading.Thread(target=writer)
        t.start()
        while t.is_alive():
            docs, cur, full = mt.docs_since(cursor)
            if cursor is not None and not full:
                assert cur[0] == cursor[0] and cur[1] >= cursor[1]
            if full:
                shadow = {d["tid"]: d for d in docs}
            else:
                shadow.update((d["tid"], d) for d in docs)
            cursor = cur
        t.join(TIMEOUT)
        assert not errs
        docs, cursor, _ = mt.docs_since(cursor)
        shadow.update((d["tid"], d) for d in docs)
        mt.refresh()
        truth = {d["tid"]: d for d in mt._dynamic_trials}
        assert shadow == truth
        assert mt.docs_since(cursor)[0] == []

    def test_quota_refused_insert_leaves_no_delta(self, tmp_path):
        tt = TenantTable([Tenant("acme", "tok-a", trials_per_s=0.001,
                                 burst=1)])
        srv = ServiceServer(str(tmp_path / "wal"), tenants=tt)
        srv.start()
        try:
            nt = _nt(srv.url, exp_key="e1", token="tok-a")
            nt._insert_trial_docs(_mk_docs([0], "e1", [0.1]))
            out = nt._rpc("fetch_since", cursor=None)
            cur = out["cursor"]
            with pytest.raises(QuotaExceeded):
                nt._insert_trial_docs(_mk_docs([1], "e1", [0.2]))
            out2 = nt._rpc("fetch_since", cursor=cur)
            assert out2["docs"] == [] and not out2["full"]
            assert out2["cursor"] == cur
        finally:
            srv.shutdown()

    def test_client_refresh_rides_deltas_end_to_end(self, tmp_path):
        wire.set_mode("binary")
        srv = ServiceServer(str(tmp_path / "wal"), token="t")
        srv.start()
        try:
            nt = _nt(srv.url, exp_key="e1", token="t")
            nt._insert_trial_docs(_mk_docs([0, 1, 2], "e1",
                                           [0.1, 0.2, 0.3]))
            nt.refresh()
            assert nt._cursor is not None
            rows0 = _counter("store.delta.rows")
            doc = nt.reserve("w0")
            nt.write_result(_complete(doc, 4.0), owner="w0")
            nt._insert_trial_docs(_mk_docs([3], "e1", [0.4]))
            nt.refresh()
            assert _counter("store.delta.rows") - rows0 <= 3
            ft = srv._store("e1", tenant=None)
            ft.refresh()
            assert [d["tid"] for d in nt._dynamic_trials] == [0, 1, 2, 3]
            assert ({d["tid"]: d["state"] for d in nt._dynamic_trials}
                    == {d["tid"]: d["state"] for d in ft._dynamic_trials})
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# mirrors: tests/test_wire.py::TestColumnarSnapshot
# ---------------------------------------------------------------------------


class TestColumnarSnapshot:
    def _drive(self, srv, token="t"):
        nt = _nt(srv.url, exp_key="e1", token=token)
        nt._insert_trial_docs(_mk_docs([0, 1, 2], "e1", [0.1, 0.2, 0.3]))
        doc = nt.reserve("w0")
        nt.write_result(_complete(doc, 7.0), owner="w0")
        nt.reserve("w1")
        return nt

    def test_format2_snapshot_tail_replay_byte_identical(self, tmp_path):
        wire.set_mode("binary")
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        nt = self._drive(srv)
        srv.snapshot()
        doc = nt.reserve("w2")
        nt.write_result(_complete(doc, 9.0), owner="w2")
        state_a = srv.state_bytes()
        srv.shutdown()
        with open(os.path.join(wal_dir, "snapshot.json")) as f:
            manifest = json.load(f)
        assert manifest["format"] == 2
        with open(os.path.join(wal_dir, manifest["sidecar"]), "rb") as f:
            assert wire.is_frame(f.read())
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            assert srv2.state_bytes() == state_a
        finally:
            srv2.shutdown()

    def test_crash_windows_mid_snapshot_retain_previous(self, tmp_path):
        wire.set_mode("binary")
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        nt = self._drive(srv)
        srv.snapshot()
        doc = nt.reserve("w2")
        nt.write_result(_complete(doc, 9.0), owner="w2")
        state_a = srv.state_bytes()
        srv.shutdown()
        orphan = os.path.join(wal_dir, "snapshot-99999999999999.slab")
        with open(orphan, "wb") as f:
            f.write(wire.encode({"stores": []}))
        with open(orphan + ".tmp.12345", "wb") as f:
            f.write(b"HTW1 torn mid-write")
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            assert srv2.state_bytes() == state_a
            srv2.snapshot()                          # prunes the debris
        finally:
            srv2.shutdown()
        left = sorted(n for n in os.listdir(wal_dir) if "slab" in n)
        assert len(left) == 1 and not left[0].endswith(".tmp")

    def test_corrupt_slab_fails_on_sha_not_silently(self, tmp_path):
        wire.set_mode("binary")
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        self._drive(srv)
        srv.snapshot()
        srv.shutdown()
        with open(os.path.join(wal_dir, "snapshot.json")) as f:
            slab = os.path.join(wal_dir, json.load(f)["sidecar"])
        blob = bytearray(open(slab, "rb").read())
        blob[-1] ^= 0xFF
        with open(slab, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError, match="sha256"):
            wal_mod.read_wal(wal_dir)

    def test_old_format1_snapshot_replays_under_binary_mode(self, tmp_path):
        wal_dir = str(tmp_path / "wal")
        wire.set_mode("json")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        nt = self._drive(srv)
        srv.snapshot()
        doc = nt.reserve("w2")
        nt.write_result(_complete(doc, 9.0), owner="w2")
        state_a = srv.state_bytes()
        srv.shutdown()
        with open(os.path.join(wal_dir, "snapshot.json")) as f:
            assert json.load(f).get("format", 1) == 1
        wire.set_mode("binary")
        srv2 = ServiceServer(wal_dir, token="t")
        try:
            assert srv2.state_bytes() == state_a
        finally:
            srv2.shutdown()

    def test_inspect_reports_slab_bytes(self, tmp_path):
        wire.set_mode("binary")
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        self._drive(srv)
        srv.snapshot()
        srv.shutdown()
        info = wal_mod.inspect(wal_dir)
        assert info["snapshot"] is not None
        with open(os.path.join(wal_dir, "snapshot.json")) as f:
            manifest = json.load(f)
        slab_sz = os.path.getsize(os.path.join(wal_dir,
                                               manifest["sidecar"]))
        assert info["snapshot"]["bytes"] >= slab_sz


# ---------------------------------------------------------------------------
# mirrors: tests/test_wire.py::TestHotColumns
# ---------------------------------------------------------------------------


class TestHotColumns:
    def _fill(self, mt, n=12):
        mt._insert_trial_docs(_mk_docs(list(range(n)), "e",
                                       [i * 0.1 for i in range(n)]))
        for i in range(0, n, 2):
            doc = mt.reserve(f"w{i}")
            mt.write_result(_complete(dict(doc), doc["tid"] * 1.0),
                            owner=f"w{i}")

    def test_history_matches_base_walk_bitwise(self):
        mt = MemTrials(exp_key="e")
        self._fill(mt)
        mt.refresh()
        cs = compile_space({"x": hp.uniform("x", -5, 5)})
        cols = mt.history(cs)
        ref = base.Trials.history(mt, cs)
        for k in ("vals", "active", "loss", "ok", "tids"):
            assert np.array_equal(np.asarray(cols[k]), np.asarray(ref[k]),
                                  equal_nan=True), k

    def test_out_of_order_completion_rebuilds_not_corrupts(self):
        mt = MemTrials(exp_key="e")
        mt._insert_trial_docs(_mk_docs([0, 1, 2], "e", [0.1, 0.2, 0.3]))
        cs = compile_space({"x": hp.uniform("x", -5, 5)})
        for tid, w in ((2, "a"), (0, "b")):
            mt._claims[tid] = w
            doc = dict(mt._by_tid[tid])
            doc["owner"] = w
            mt.history(cs)            # materialize between completions
            mt.write_result(_complete(doc, float(tid)), owner=w)
        mt.refresh()
        cols = mt.history(cs)
        ref = base.Trials.history(mt, cs)
        for k in ("vals", "active", "loss", "ok", "tids"):
            assert np.array_equal(np.asarray(cols[k]), np.asarray(ref[k]),
                                  equal_nan=True), k

    def test_disabled_gate_falls_back_to_base(self):
        mt = MemTrials(exp_key="e", columns=False)
        self._fill(mt, n=4)
        assert not mt.columns
        mt.refresh()
        cs = compile_space({"x": hp.uniform("x", -5, 5)})
        ref = base.Trials.history(mt, cs)
        cols = mt.history(cs)
        assert mt._col is None
        for k in ("vals", "active", "loss", "ok", "tids"):
            assert np.array_equal(np.asarray(cols[k]), np.asarray(ref[k]),
                                  equal_nan=True), k
