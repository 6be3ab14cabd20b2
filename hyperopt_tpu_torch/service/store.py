"""In-memory trial store with the file store's verb surface.

Counterpart of ``hyperopt_tpu/service/store.py``.  The service keeps every
tenant's trials in RAM (a verb is a dict operation instead of a JSON-file
rewrite) and gets durability from the write-ahead log
(:mod:`hyperopt_tpu_torch.service.wal`).  For replay to rebuild a
byte-identical store, every time-dependent mutation reads the clock
through :meth:`MemTrials._now`, which the server points at the timestamp
it logged in the WAL record: live execution and replay see the same
clock.

The verbs mirror :class:`~hyperopt_tpu_torch.parallel.filestore.FileTrials`
(reserve claim commit, heartbeat as a stamp-refresh-only liveness signal,
owner fencing on write, stale requeue), except that in memory the claim
and the RUNNING flip commit together under one lock, so a claim never
outlives its doc state.

The columnar ``history``/``inflight`` (``columns=True``, the default;
the JAX package's environment switch) keep completed rows
in capacity-doubled buffers filled as results land; ``history(cs)``
returns views of them, which the device-resident ring
(:mod:`hyperopt_tpu_torch.history`) uploads from, new tids only.
"""

from __future__ import annotations

import base64
import itertools
import json
import time
from typing import List, Optional

import numpy as np

from ..base import (
    COARSE_CLOCK_SLOP_S,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_OK,
    Trials,
    _parse_doc_row,
    coarse_utcnow,
)
from ..exceptions import InvalidTrial
from ..obs import metrics as _metrics
from ..obs.events import EVENTS

__all__ = ["MemTrials"]

#: Delta-cursor epoch source: a per-process boot salt (stamped once at
#: import — never on the WAL replay path, which must stay entropy-free)
#: plus a monotone counter.  Epochs need uniqueness across restarts and
#: delete_all generations, not secrecy or determinism: a stale cursor
#: whose epoch no longer matches just gets one full resend.
_EPOCH_SALT = int(time.time() * 1000) % (1 << 32)
_EPOCH_SEQ = itertools.count(1)


class MemTrials(Trials):
    """Server-resident ``Trials`` with the claim/heartbeat/requeue verbs.

    ``asynchronous = True``: like the file and network stores, this is a
    queue that external workers drain — ``fmin`` against it only
    enqueues.  One instance per (tenant, exp_key) lives inside the
    service server; the server's dispatch lock serializes all access.
    """

    asynchronous = True

    def __init__(self, exp_key: str = "default", refresh=True,
                 columns: bool = True):
        #: Columnar history/inflight (False: the base class's doc walks,
        #: the A/B arm).
        self.columns = bool(columns)
        # Claim table: tid -> owner (the .claim files of the filestore).
        self._claims: dict = {}
        # Migration fence: a fenced store refuses mutating verbs at the
        # server dispatch layer (typed ShardFenced redirect) while its
        # state moves to another shard.  Durable — it rides state_dict()
        # and the WAL ``store_fence`` record — so a donor that crashes
        # mid-migration recovers still fenced instead of resurrecting a
        # store whose ownership moved away.
        self._fenced: bool = False
        # tids handed out by new_trial_ids but possibly not yet inserted
        # (the filestore's exclusive-create marker files).
        self._allocated: set = set()
        self._by_tid: dict = {}
        self._domain_blob: bytes | None = None
        # Deterministic-replay clock: when set, _now() returns this value
        # instead of the wall clock.  The service server points it at the
        # WAL record's logged timestamp around every mutating verb.
        self.now_override: float | None = None
        # -- delta-fetch bookkeeping (fetch_since verb) ----------------------
        # Epoch token: any event that could reset mutation-seq monotonicity
        # (fresh store, restart+replay, delete_all) mints a new random epoch,
        # so a stale client cursor can never silently skip rows — an epoch
        # mismatch just costs one full resend.  Never replayed, never in
        # state_dict(), so WAL byte-identity is untouched.
        self._epoch: int = self._new_epoch()
        self._seq_mut: int = 0
        # tid -> mutation seq, *insertion-ordered ascending by seq* (touch
        # pops + reinserts), so reversed() iteration yields the delta in
        # O(changed rows) instead of O(all rows).
        self._revs: dict = {}
        # -- hot-column bookkeeping (columnar history/inflight) --------------
        self._live: set = set()        # NEW/RUNNING tids (exp_key-matching)
        self._done_tids: list = []     # DONE tids mirrored into columns
        self._done_set: set = set()
        self._done_pending: list = []  # docs awaiting column append
        self._col: dict | None = None  # capacity-doubled column buffers
        self._col_dirty: bool = True
        # -- list-view maintenance -------------------------------------------
        self._pos: dict = {}           # tid -> index in _dynamic_trials
        self._tpos: dict = {}          # tid -> index in _trials
        self._list_dirty: bool = True
        self._export_cache: tuple | None = None
        super().__init__(exp_key=exp_key, refresh=refresh)

    @staticmethod
    def _new_epoch() -> int:
        # 48-bit salt field + counter: fits i64 on any framed wire path.
        return (_EPOCH_SALT << 16) + next(_EPOCH_SEQ)

    def _match_key(self, doc) -> bool:
        return self._exp_key is None or doc.get("exp_key") == self._exp_key

    def _touch(self, tid) -> None:
        """Record a row mutation for delta fetch.  Callers already hold
        the store lock (RLock) or run under the server dispatch lock."""
        self._seq_mut += 1
        self._revs.pop(tid, None)
        self._revs[tid] = self._seq_mut
        self._export_cache = None

    def _note_state(self, doc) -> None:
        """Maintain the live set and the append-only DONE column feed for
        one (possibly replaced) stored doc."""
        if not self._match_key(doc):
            self._col_dirty = True
            return
        tid, state = doc["tid"], doc["state"]
        if state in (JOB_STATE_NEW, JOB_STATE_RUNNING):
            self._live.add(tid)
        else:
            self._live.discard(tid)
        if state == JOB_STATE_DONE:
            if tid in self._done_set:
                # result rewritten after completion: full rebuild
                self._col_dirty = True
            elif self._done_tids and tid < self._done_tids[-1]:
                # out-of-order completion: same cost the base prefix
                # cache pays (its tid-prefix check also forces a reparse)
                self._col_dirty = True
            else:
                self._done_tids.append(tid)
                self._done_set.add(tid)
                self._done_pending.append(doc)
        elif tid in self._done_set:
            self._col_dirty = True

    def _now(self) -> float:
        return (self.now_override if self.now_override is not None
                else coarse_utcnow())

    # -- document IO ---------------------------------------------------------

    def _insert_trial_docs(self, docs) -> List[int]:
        # Duplicate guard lives HERE (not only in the validated public
        # wrapper): the netstore dispatch inserts through this hook, and
        # appending a duplicate tid would corrupt the in-memory list where
        # the filestore would merely rewrite the same file.
        for d in docs:
            if d["tid"] in self._by_tid:
                raise InvalidTrial(f"duplicate tid {d['tid']}")
        in_order = sorted(docs, key=lambda d: d["tid"])
        append = (not self._list_dirty
                  and (not self._dynamic_trials
                       or in_order[0]["tid"] > self._dynamic_trials[-1]["tid"]))
        for d in in_order:
            self._by_tid[d["tid"]] = d
            self._allocated.add(d["tid"])
            self._ids.add(d["tid"])
            self._touch(d["tid"])
            self._note_state(d)
            if append:
                # steady-state path: monotone tids extend the sorted views
                # in place instead of resorting O(n log n) per insert
                self._pos[d["tid"]] = len(self._dynamic_trials)
                self._dynamic_trials.append(d)
                if self._match_key(d):
                    self._tpos[d["tid"]] = len(self._trials)
                    self._trials.append(d)
        if not append:
            self._list_dirty = True
            self.refresh()
        self._best_cache = None
        return [d["tid"] for d in docs]

    def refresh(self):
        with self._lock:
            # State flips mutate docs in place (same object in every
            # view), so a clean store only needs the best-trial cache
            # invalidated — the filtered list is already current.
            if not self._list_dirty:
                self._best_cache = None
                return
            self._dynamic_trials = sorted(self._by_tid.values(),
                                          key=lambda d: d["tid"])
            self._pos = {d["tid"]: i
                         for i, d in enumerate(self._dynamic_trials)}
            super().refresh()
            self._tpos = {d["tid"]: i for i, d in enumerate(self._trials)}
            self._list_dirty = False

    def export_docs(self) -> list:
        """Reply-safe snapshot: per-doc shallow copies, so the server can
        serialize the reply outside the store lock while later verbs
        mutate top-level keys of the live docs.  Cached until the next
        row mutation (cold read verbs materialize docs lazily)."""
        with self._lock:
            cached = self._export_cache
            if cached is not None and cached[0] == self._seq_mut:
                return cached[1]
            self.refresh()
            docs = [dict(d) for d in self._dynamic_trials]
            self._export_cache = (self._seq_mut, docs)
            return docs

    def new_trial_ids(self, n):
        with self._lock:
            base = max([max(self._allocated, default=-1),
                        max(self._ids, default=-1)]) + 1
            out = list(range(base, base + n))
            self._allocated.update(out)
            return out

    def delete_all(self):
        with self._lock:
            self._claims = {}
            self._allocated = set()
            self._by_tid = {}
            self._domain_blob = None
            self._epoch = self._new_epoch()
            self._seq_mut = 0
            self._revs = {}
            self._live = set()
            self._done_tids = []
            self._done_set = set()
            self._done_pending = []
            self._col = None
            self._col_dirty = True
            self._pos = {}
            self._tpos = {}
            self._list_dirty = False
            self._export_cache = None
            super().delete_all()

    # -- domain shipping -----------------------------------------------------

    def put_domain_blob(self, blob: bytes) -> None:
        self._domain_blob = bytes(blob)

    def get_domain_blob(self) -> Optional[bytes]:
        return self._domain_blob

    def save_domain(self, domain) -> None:
        from ..parallel.filestore import _pickler
        self.put_domain_blob(_pickler.dumps(domain))

    def load_domain(self):
        import pickle
        if self._domain_blob is None:
            raise FileNotFoundError("no domain published for "
                                    f"exp_key={self._exp_key!r}")
        return pickle.loads(self._domain_blob)

    # -- reservation / claim lifecycle --------------------------------------

    def reserve(self, owner: str) -> Optional[dict]:
        """Claim the first NEW trial for ``owner`` (claim + RUNNING flip
        commit atomically under the lock); None when the queue is empty."""
        with self._lock:
            self.refresh()
            for doc in self._trials:
                if doc["state"] != JOB_STATE_NEW:
                    continue
                if doc["tid"] in self._claims:
                    _metrics.registry().counter(
                        "store.claim.contended").inc()
                    continue
                self._claims[doc["tid"]] = owner
                doc["state"] = JOB_STATE_RUNNING
                doc["owner"] = owner
                doc["book_time"] = self._now()
                doc["refresh_time"] = doc["book_time"]
                self._touch(doc["tid"])
                _metrics.registry().counter("store.claim.won").inc()
                EVENTS.emit("store_claim", trial=doc["tid"], owner=owner)
                return dict(doc)
            return None

    def owns(self, doc, owner: str) -> bool:
        return self._claims.get(doc["tid"]) == owner

    def heartbeat(self, doc, owner: Optional[str] = None) -> bool:
        """Liveness stamp only: re-read the stored doc and rewrite just
        ``refresh_time`` (the filestore's lost-update fix, verbatim)."""
        with self._lock:
            if owner is not None and not self.owns(doc, owner):
                _metrics.registry().counter("store.heartbeat.fenced").inc()
                EVENTS.emit("store_heartbeat", trial=doc["tid"],
                            owner=owner, ok=False)
                return False
            cur = self._by_tid.get(doc["tid"])
            if cur is None:
                return False
            if cur["state"] != JOB_STATE_RUNNING:
                return cur["state"] in (JOB_STATE_DONE, JOB_STATE_ERROR)
            cur["refresh_time"] = self._now()
            doc["refresh_time"] = cur["refresh_time"]
            self._touch(cur["tid"])
            return True

    def write_result(self, doc, owner: Optional[str] = None) -> bool:
        with self._lock:
            if owner is not None and not self.owns(doc, owner):
                _metrics.registry().counter("store.write.fenced").inc()
                return False
            stored = dict(doc)
            stored["refresh_time"] = self._now()
            tid = stored["tid"]
            prev = self._by_tid.get(tid)
            self._by_tid[tid] = stored
            self._ids.add(tid)
            self._allocated.add(tid)
            # The replaced doc object must also land in the list views;
            # patch them in place when they're current (the steady-state
            # path), fall back to a dirty rebuild otherwise.
            if (not self._list_dirty and prev is not None
                    and prev.get("exp_key") == stored.get("exp_key")):
                i = self._pos.get(tid)
                if i is not None:
                    self._dynamic_trials[i] = stored
                j = self._tpos.get(tid)
                if j is not None:
                    self._trials[j] = stored
                self._best_cache = None
            else:
                self._list_dirty = True
            self._touch(tid)
            self._note_state(stored)
        _metrics.registry().counter("store.write.ok").inc()
        EVENTS.emit("store_write", trial=stored["tid"],
                    state=stored.get("state"))
        return True

    def requeue_stale(self, timeout: float) -> int:
        """Requeue RUNNING trials whose heartbeat went silent (the only
        stale shape in memory — orphan claims cannot exist here)."""
        n = 0
        with self._lock:
            now = self._now()
            for doc in self._by_tid.values():
                if doc["state"] != JOB_STATE_RUNNING:
                    continue
                last = doc.get("refresh_time") or doc.get("book_time") or 0
                # Both clocks are coarse here, but a beat at second S
                # and a sweep at S+1 still differ by a full tick after
                # milliseconds of real silence — same slop as filestore.
                if now - last > timeout + COARSE_CLOCK_SLOP_S:
                    owner = doc.get("owner")
                    self._claims.pop(doc["tid"], None)
                    doc["state"] = JOB_STATE_NEW
                    doc["owner"] = None
                    self._touch(doc["tid"])
                    n += 1
                    EVENTS.emit("store_requeue", trial=doc["tid"],
                                owner=owner, reason="stale_heartbeat")
            if n:
                _metrics.registry().counter("store.requeued").inc(n)
                self.refresh()
        return n

    # -- delta fetch (fetch_since verb) --------------------------------------

    def docs_since(self, cursor=None):
        """Rows touched since ``cursor`` (``[epoch, seq]``), plus the new
        cursor and a ``full`` flag.  A missing/stale/foreign-epoch cursor
        gets the complete doc list — delta correctness never depends on
        the client's bookkeeping, only its efficiency does."""
        with self._lock:
            cur = [self._epoch, self._seq_mut]
            ok_cursor = (isinstance(cursor, (list, tuple))
                         and len(cursor) == 2)
            if ok_cursor:
                try:
                    ok_cursor = (int(cursor[0]) == self._epoch
                                 and 0 <= int(cursor[1]) <= self._seq_mut)
                except (TypeError, ValueError):
                    ok_cursor = False
            if not ok_cursor:
                self.refresh()
                return ([dict(d) for d in self._dynamic_trials], cur, True)
            since = int(cursor[1])
            touched = []
            for tid in reversed(self._revs):
                if self._revs[tid] <= since:
                    break
                touched.append(tid)
            touched.sort()
            docs = [dict(self._by_tid[t]) for t in touched
                    if t in self._by_tid]
            _metrics.registry().counter("store.delta.rows").inc(len(docs))
            return docs, cur, False

    # -- columnar history (feeds the device-resident ring) -------------------

    def history(self, cs):
        """O(Δ) dense history at steady state: completed rows are parsed
        once into capacity-doubled column buffers when their result
        lands, and each call returns views, with no per-call doc walk.
        Rows below ``n`` are never written again (growth copies into new
        buffers), so a view handed out stays valid; the device ring
        uploads the rows whose tids are new."""
        if not self.columns:
            return super().history(cs)
        with self._lock:
            col = self._col
            if self._col_dirty or col is None or col["cs"] is not cs:
                self._rebuild_columns(cs)
                col = self._col
            elif self._done_pending:
                # A growing append replaces the buffers: read the new
                # ones.  (The JAX package returns the old buffers here, a
                # history missing the rows just appended.)
                self._append_columns(col)
                col = self._col
            n = col["n"]
            return dict(vals=col["vals"][:n], active=col["active"][:n],
                        loss=col["loss"][:n], ok=col["ok"][:n],
                        tids=col["tids"][:n])

    def inflight(self, cs):
        """Dense NEW/RUNNING view from the maintained live-tid set —
        O(in-flight) instead of the base class's O(all trials) scan."""
        if not self.columns:
            return super().inflight(cs)
        with self._lock:
            live = [self._by_tid[t] for t in sorted(self._live)
                    if t in self._by_tid]
            m, p = len(live), cs.n_params
            vals = np.zeros((m, p), dtype=np.float32)
            active = np.zeros((m, p), dtype=bool)
            for i, t in enumerate(live):
                _parse_doc_row(t["misc"]["vals"], cs, vals, active, i)
            return vals, active

    @staticmethod
    def _col_alloc(cap, p):
        return {
            "vals": np.zeros((cap, p), dtype=np.float32),
            "active": np.zeros((cap, p), dtype=bool),
            "loss": np.full((cap,), np.inf, dtype=np.float32),
            "ok": np.zeros((cap,), dtype=bool),
            "tids": np.zeros((cap,), dtype=np.int64),
        }

    def _fill_row(self, col, i, doc):
        r = doc["result"]
        if (r.get("status") == STATUS_OK and r.get("loss") is not None
                and np.isfinite(r["loss"])):
            col["loss"][i] = r["loss"]
            col["ok"][i] = True
        else:
            col["loss"][i] = np.inf
            col["ok"][i] = False
        col["vals"][i] = 0.0
        col["active"][i] = False
        _parse_doc_row(doc["misc"]["vals"], cs=col["cs"], vals=col["vals"],
                       active=col["active"], i=i)
        col["tids"][i] = doc["tid"]

    def _rebuild_columns(self, cs):
        self.refresh()
        done = [t for t in self._trials if t["state"] == JOB_STATE_DONE]
        n, p = len(done), cs.n_params
        cap = max(64, 2 * n)
        col = self._col_alloc(cap, p)
        col["cs"] = cs
        col["n"] = n
        for i, t in enumerate(done):
            self._fill_row(col, i, t)
        self._col = col
        self._done_tids = [t["tid"] for t in done]
        self._done_set = set(self._done_tids)
        self._done_pending = []
        self._col_dirty = False
        _metrics.registry().counter("store.columns.rebuilds").inc()

    def _append_columns(self, col):
        pending, self._done_pending = self._done_pending, []
        need = col["n"] + len(pending)
        if need > len(col["tids"]):
            cap = max(2 * len(col["tids"]), 2 * need)
            p = col["vals"].shape[1]
            grown = self._col_alloc(cap, p)
            m = col["n"]
            for k in ("vals", "active", "loss", "ok", "tids"):
                grown[k][:m] = col[k][:m]
            grown["cs"], grown["n"] = col["cs"], m
            col = self._col = grown
        for doc in pending:
            self._fill_row(col, col["n"], doc)
            col["n"] += 1
        _metrics.registry().counter("store.columns.rows").inc(len(pending))

    # -- durable state (snapshot / byte-identity) ----------------------------

    def state_dict(self) -> dict:
        """Canonical JSON-serializable state: everything replay must
        reconstruct.  Deterministically ordered so two stores are equal
        iff their ``json.dumps(..., sort_keys=True)`` bytes are equal."""
        with self._lock:
            return {
                "exp_key": self._exp_key,
                "docs": sorted((dict(d) for d in self._by_tid.values()),
                               key=lambda d: d["tid"]),
                "claims": {str(t): o
                           for t, o in sorted(self._claims.items())},
                "allocated": sorted(self._allocated),
                "domain_blob": (None if self._domain_blob is None else
                                base64.b64encode(
                                    self._domain_blob).decode()),
                "attachments": {
                    str(k): base64.b64encode(self._att_blob(k)).decode()
                    for k in sorted(self.attachments, key=str)},
                "fenced": bool(self._fenced),
            }

    def state_bytes(self) -> bytes:
        return json.dumps(self.state_dict(), sort_keys=True).encode()

    def _att_blob(self, key) -> bytes:
        from ..parallel.filestore import _pickler
        return _pickler.dumps(self.attachments[key])

    @property
    def fenced(self) -> bool:
        return self._fenced

    def fence(self, drop: bool = False, lift: bool = False) -> None:
        """Raise (or, with ``drop``, finalize) the migration fence.

        ``drop=False`` quiesces the store: it stays readable (the
        migration exports through the read path) but the dispatch layer
        refuses mutations.  ``drop=True`` is the donor-side tombstone
        after a successful export — the moved documents are released so
        the donor's memory shrinks, while the fence itself stays set so
        a stale client retry can never fork the moved store.
        ``lift=True`` is the migration ROLLBACK: a cutover that failed
        before the import landed moved nothing, so the fence must not
        outlive it — the store returns to service with every document
        and claim intact.  All three are WAL-replayed (``store_fence``),
        so recovery lands in the same place."""
        with self._lock:
            if lift:
                self._fenced = False
                return
            self._fenced = True
            if drop:
                self._claims = {}
                self._allocated = set()
                self._by_tid = {}
                self._ids = set()
                self._domain_blob = None
                self.attachments = {}
                self._epoch = self._new_epoch()
                self._seq_mut = 0
                self._revs = {}
                self._live = set()
                self._done_tids = []
                self._done_set = set()
                self._done_pending = []
                self._col = None
                self._col_dirty = True
                self._pos = {}
                self._tpos = {}
                self._list_dirty = True
                self._export_cache = None
                self.refresh()

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._fenced = bool(state.get("fenced", False))
            self._by_tid = {d["tid"]: dict(d) for d in state["docs"]}
            self._claims = {int(t): o
                            for t, o in state.get("claims", {}).items()}
            self._allocated = set(state.get("allocated", []))
            self._ids = set(self._by_tid)
            blob = state.get("domain_blob")
            self._domain_blob = (None if blob is None
                                 else base64.b64decode(blob))
            from ..parallel.netstore import safe_loads
            self.attachments = {
                k: safe_loads(base64.b64decode(b))
                for k, b in state.get("attachments", {}).items()}
            # Bulk state swap: mint a fresh delta epoch (stale client
            # cursors full-resync) and rebuild every derived view.
            self._epoch = self._new_epoch()
            self._seq_mut = 0
            self._revs = {}
            for d in self._by_tid.values():
                self._touch(d["tid"])
            self._live = set()
            self._done_tids = []
            self._done_set = set()
            self._done_pending = []
            self._col = None
            self._col_dirty = True
            self._export_cache = None
            self._list_dirty = True
            self.refresh()
            for d in self._dynamic_trials:
                self._note_state(d)
