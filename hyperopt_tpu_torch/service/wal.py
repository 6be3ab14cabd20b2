"""Write-ahead log + snapshot/compaction for the suggestion service.

Counterpart of ``hyperopt_tpu/service/wal.py``, writing and reading the
same files: a WAL directory written by either package recovers in the
other.

Durability model: a *logical* WAL, append-before-execute.

* Every mutating verb is serialized to one JSON line in ``wal.jsonl``
  before it executes, under the lock that executes it, so the log order
  is the execution order.
* Each record carries the second-resolution timestamp ``t`` the server
  then uses as the verb's clock (``MemTrials.now_override``): replay
  re-executes the verb with the logged clock and rebuilds the store
  byte-identically (``MemTrials.state_bytes``), claim tables and requeue
  decisions included.
* A server-side ``suggest`` with insert is logged as a physical
  ``insert_docs`` record (the proposed docs, verbatim): replay never
  re-runs a head, so recovery needs no card.
* The idempotency key of the original client call rides in the record,
  so replay also refills the exactly-once reply cache.

Crash safety: a record is one ``write`` of one line; a crash mid-append
leaves at most one torn final line, which replay detects, counts
(``wal.torn_tail``) and drops: the verb it described was never acked.

Fsync policy: ``always`` (an fsync per append: an acked verb survives
SIGKILL and power loss; the default), ``batch`` (every ``batch_every``
appends: survives process death) or ``never`` (the OS flushes).

Group commit (``group_commit=True``, the default; it matters only at
``fsync="always"``): ``append`` writes and flushes the record under the
dispatch lock, and the fsync moves into :meth:`Wal.wait_durable`, which
the server calls after releasing the dispatch lock and before acking
the client.  Concurrent waiters elect one leader, which fsyncs once for
every record flushed so far and wakes the waiters it covered.  No verb
is acked before a covering fsync.

``crash="kill"`` turns an injected ``wal.write`` / ``wal.fsync`` fault
into a SIGKILL of the current process at that boundary (the chaos
tests' way of dying with no teardown); run it only in a child process.

Snapshot + compaction: ``snapshot()`` writes the full server state
tagged with the last applied ``seq`` and truncates ``wal.jsonl``;
recovery loads the snapshot and replays the records past it.  The
snapshot format follows the wire mode (:func:`..wire.set_mode`): format
2, a small JSON manifest plus the store state as one binary frame in
``snapshot-<seq>.slab``, unless the mode is ``json`` (format 1, one JSON
file).  Recovery reads both.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import threading
import time

from .. import faults as _faults
from .. import wire as _wire
from ..exceptions import InjectedFault
from ..obs import flight as _flight
from ..obs import metrics as _metrics

__all__ = ["Wal", "read_wal", "inspect"]

_WAL_FILE = "wal.jsonl"
_SNAP_FILE = "snapshot.json"
#: Format-2 snapshot sidecar: ``snapshot.json`` becomes a small manifest
#: (seq, t_wall, idem cache, sidecar name + sha256) and the bulk store
#: state goes to ``snapshot-<seq>.slab`` as one binary wire frame.  The
#: slab is written and fsynced before the manifest replaces
#: ``snapshot.json``, and older slabs are pruned only after that commit:
#: a manifest on disk always names a complete slab.
_SLAB_PREFIX = "snapshot-"
_SLAB_SUFFIX = ".slab"


class Wal:
    """Appender half: owns the open ``wal.jsonl`` of one server.

    ``group_commit`` moves the per-record fsync of ``fsync="always"``
    into :meth:`wait_durable`; ``crash="kill"`` makes an injected
    ``wal.write``/``wal.fsync`` fault SIGKILL the process."""

    def __init__(self, root: str, fsync: str = "always",
                 batch_every: int = 64, group_commit: bool = True,
                 crash: str | None = None):
        if fsync not in ("always", "batch", "never"):
            raise ValueError(f"fsync policy {fsync!r}: "
                             "want always|batch|never")
        if crash not in (None, "kill"):
            raise ValueError(f"crash {crash!r}: want None or 'kill'")
        self.crash = crash
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.fsync = fsync
        self.batch_every = max(1, int(batch_every))
        #: Effective only at fsync=always; other policies never block acks
        #: on an fsync, so there is no commit to group.
        self.group_commit = bool(group_commit) and fsync == "always"
        self._sync_cv = threading.Condition()
        self._flushed_seq = 0    # last seq written+flushed (under _sync_cv)
        self._synced_seq = 0     # last seq covered by an fsync
        self._sync_leader = False
        self.path = os.path.join(self.root, _WAL_FILE)
        self.snap_path = os.path.join(self.root, _SNAP_FILE)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._since_sync = 0
        self._last_fsync_mono = time.monotonic()
        self.seq = 0                    # last seq handed out; set by recovery
        #: Optional append fan-out hook: called with each record (seq
        #: stamped) after it is durably written — the replication
        #: shipper's feed.  Must be O(1)/no-IO: it runs under the
        #: dispatch lock.
        self.listener = None
        #: Optional pre-crash hook for the simulated WAL-crash path:
        #: called (bounded, best-effort) right before the SIGKILL so a
        #: host server can drain in-flight replication.  The kill
        #: models dying at the append boundary with replication caught
        #: up — the chaos suite proves failover/replay exactly-once,
        #: not async shipping lag.
        self.crash_hook = None

    def append(self, rec: dict, seq: int | None = None) -> int:
        """Serialize ``rec`` (gets ``seq`` assigned here, unless a
        replica forces the primary's), write + flush per policy, and
        return the seq.  Raises before any byte is written when a
        ``wal.write`` fault fires."""
        try:
            _faults.maybe_fail("wal.write", verb=rec.get("verb"))
        except InjectedFault:
            if self.crash == "kill":
                # Die at the append boundary with zero teardown — the
                # SIGKILL the chaos suite uses to prove replay.  A
                # SIGKILL runs no handlers, so the postmortem bundle is
                # frozen HERE, before the shot (no-op when the flight
                # recorder is disarmed).
                self._fh.flush()
                if self.crash_hook is not None:
                    try:
                        self.crash_hook()
                    except Exception:  # noqa: BLE001 - dying anyway
                        pass
                _flight.dump("wal-crash", force=True,
                             extra={"trigger": "wal_crash",
                                    "verb": rec.get("verb")})
                os.kill(os.getpid(), signal.SIGKILL)
            raise
        self.seq = self.seq + 1 if seq is None else int(seq)
        rec = dict(rec, seq=self.seq)
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        self._fh.write(line)
        self._fh.flush()
        self._since_sync += 1
        if self.group_commit:
            # fsync=always with group commit: the covering fsync happens
            # in wait_durable (leader-elected, after the dispatch lock is
            # released) — the verb is not acked until it runs.
            with self._sync_cv:
                self._flushed_seq = self.seq
        elif self.fsync == "always" or (self.fsync == "batch"
                                        and self._since_sync
                                        >= self.batch_every):
            os.fsync(self._fh.fileno())
            self._since_sync = 0
            self._last_fsync_mono = time.monotonic()
            _metrics.registry().counter("wal.fsyncs").inc()
        reg = _metrics.registry()
        reg.counter("wal.appends").inc()
        reg.counter("wal.bytes").inc(len(line))
        # Durability lag: how far behind a durable fsync this acked
        # append is (0 under fsync=always) — the wal_fsync_lag SLO feed.
        reg.gauge("wal.fsync_lag_s").set(
            time.monotonic() - self._last_fsync_mono)
        if self.listener is not None:
            self.listener(rec)
        return self.seq

    def wait_durable(self, seq: int) -> None:
        """Block until every record at or below ``seq`` is covered by an
        fsync (group-commit mode; a no-op otherwise).  Exactly one
        concurrent waiter at a time is elected leader and fsyncs once
        for the whole flushed batch; everyone whose record the fsync
        covered returns.  Call with NO other lock held — the leader's
        fsync would otherwise serialize the very verbs it amortizes."""
        if not self.group_commit:
            return
        while True:
            with self._sync_cv:
                while self._synced_seq < seq and self._sync_leader:
                    self._sync_cv.wait()
                if self._synced_seq >= seq:
                    return
                self._sync_leader = True
                hwm = self._flushed_seq
            self._leader_fsync(hwm)

    def _leader_fsync(self, hwm: int) -> None:
        """One covering fsync for every record flushed at or below
        ``hwm``; wakes all waiters.  Runs outside ``_sync_cv`` so
        followers can enqueue while the disk syncs.  On an injected
        ``wal.fsync`` fault, leadership is handed back (a later waiter
        re-elects and fsyncs the still-flushed batch) and the fault
        propagates to the waiter being acked."""
        try:
            try:
                _faults.maybe_fail("wal.fsync")
            except InjectedFault:
                if self.crash == "kill":
                    # Die at the group-commit boundary: records are
                    # flushed but no covering fsync ran, and no waiter
                    # has been acked — the chaos suite's probe that an
                    # un-acked batch never half-applies.
                    if self.crash_hook is not None:
                        try:
                            self.crash_hook()
                        except Exception:  # noqa: BLE001 - dying anyway
                            pass
                    _flight.dump("wal-crash", force=True,
                                 extra={"trigger": "wal_fsync_crash"})
                    os.kill(os.getpid(), signal.SIGKILL)
                raise
            os.fsync(self._fh.fileno())
        except BaseException:
            with self._sync_cv:
                self._sync_leader = False
                self._sync_cv.notify_all()
            raise
        now = time.monotonic()
        reg = _metrics.registry()
        with self._sync_cv:
            covered = hwm - self._synced_seq
            self._synced_seq = max(self._synced_seq, hwm)
            self._sync_leader = False
            self._since_sync = 0
            self._last_fsync_mono = now
            self._sync_cv.notify_all()
        reg.counter("wal.fsyncs").inc()
        reg.histogram("wal.group_size").observe(max(covered, 0))
        reg.gauge("wal.fsync_lag_s").set(0.0)

    def snapshot(self, payload: dict) -> None:
        """Atomically persist ``payload`` (stamped with the current seq)
        and truncate the log — records at or below ``seq`` are folded in.
        """
        # Take group-commit leadership for the truncation window so an
        # in-flight leader never fsyncs a file handle we are replacing.
        if self.group_commit:
            with self._sync_cv:
                while self._sync_leader:
                    self._sync_cv.wait()
                self._sync_leader = True
        try:
            payload = dict(payload, seq=self.seq, t_wall=time.time())
            if _wire.mode() != "json":
                self._write_columnar(payload)
            else:
                tmp = f"{self.snap_path}.tmp.{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(payload, f, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.snap_path)
            # Compaction: everything the snapshot covers leaves the log.
            self._fh.close()
            self._fh = open(self.path, "w", encoding="utf-8")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._since_sync = 0
            _metrics.registry().counter("wal.snapshots").inc()
        finally:
            if self.group_commit:
                # The snapshot durably covers every record it folded in.
                with self._sync_cv:
                    self._flushed_seq = max(self._flushed_seq, self.seq)
                    self._synced_seq = max(self._synced_seq, self.seq)
                    self._sync_leader = False
                    self._last_fsync_mono = time.monotonic()
                    self._sync_cv.notify_all()

    def _write_columnar(self, payload: dict) -> None:
        """Format-2 snapshot: binary slab sidecar first, manifest commit
        second, prune third (see the ordering note at ``_SLAB_PREFIX``).
        """
        slab_name = f"{_SLAB_PREFIX}{self.seq:016d}{_SLAB_SUFFIX}"
        slab_path = os.path.join(self.root, slab_name)
        frame = _wire.encode({"stores": payload.get("stores", [])})
        tmp = f"{slab_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, slab_path)
        manifest = {k: v for k, v in payload.items() if k != "stores"}
        manifest.update(format=2, sidecar=slab_name,
                        sha256=hashlib.sha256(frame).hexdigest())
        tmp = f"{self.snap_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        _metrics.registry().counter("wal.snapshot.slab_bytes").inc(
            len(frame))
        # Only now is the previous snapshot's slab unreferenced.
        for name in os.listdir(self.root):
            if (name.startswith(_SLAB_PREFIX) and name != slab_name
                    and (name.endswith(_SLAB_SUFFIX)
                         or ".tmp." in name)):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass

    def close(self) -> None:
        try:
            self._fh.flush()
            if self.fsync != "never":
                os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            pass
        self._fh.close()


def read_wal(root: str):
    """Recovery read: ``(snapshot | None, records, n_torn)``.

    ``records`` are the log lines with ``seq`` greater than the
    snapshot's (compaction may leave already-folded lines behind if a
    crash hit between snapshot write and truncate — they are skipped
    here, which makes the snapshot-then-truncate pair crash-safe in
    either order).  A torn (truncated) final line is dropped and
    counted; torn *interior* lines are real corruption and raise.
    """
    snap = None
    snap_path = os.path.join(root, _SNAP_FILE)
    if os.path.exists(snap_path):
        with open(snap_path, encoding="utf-8") as f:
            snap = json.load(f)
    if snap is not None and snap.get("format") == 2:
        # Columnar manifest: pull the store state back from the binary
        # sidecar and present the same dict shape a format-1 snapshot
        # had — recovery code never sees the difference.
        slab_path = os.path.join(root, snap["sidecar"])
        with open(slab_path, "rb") as f:
            frame = f.read()
        if hashlib.sha256(frame).hexdigest() != snap.get("sha256"):
            raise ValueError(
                f"{slab_path}: snapshot sidecar sha256 mismatch "
                "(corrupt or partial slab referenced by the manifest)")
        hot = _wire.decode(frame)
        snap = {k: v for k, v in snap.items()
                if k not in ("format", "sidecar", "sha256")}
        snap["stores"] = hot.get("stores", [])
    min_seq = snap["seq"] if snap else 0
    records, n_torn = [], 0
    wal_path = os.path.join(root, _WAL_FILE)
    if os.path.exists(wal_path):
        with open(wal_path, encoding="utf-8") as f:
            lines = f.readlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    n_torn += 1     # crash mid-append: verb never acked
                    break
                raise ValueError(
                    f"{wal_path}: corrupt record at line {i + 1} "
                    "(not the torn tail)")
            if rec["seq"] > min_seq:
                records.append(rec)
    if n_torn:
        _metrics.registry().counter("wal.torn_tail").inc(n_torn)
    return snap, records, n_torn


def inspect(root: str) -> dict:
    """Offline summary of a WAL directory: the snapshot's seq, stores and
    bytes, the tail's records per verb and per store, the torn tail."""
    snap, records, n_torn = read_wal(root)
    per_verb: dict = {}
    per_store: dict = {}
    for r in records:
        per_verb[r["verb"]] = per_verb.get(r["verb"], 0) + 1
        key = f"{r.get('tenant') or '-'}/{r.get('exp_key', 'default')}"
        per_store[key] = per_store.get(key, 0) + 1
    wal_path = os.path.join(root, _WAL_FILE)
    snap_path = os.path.join(root, _SNAP_FILE)
    slab_bytes = sum(
        os.path.getsize(os.path.join(root, n)) for n in os.listdir(root)
        if n.startswith(_SLAB_PREFIX) and n.endswith(_SLAB_SUFFIX))
    return {
        "root": os.path.abspath(root),
        "snapshot": None if snap is None else {
            "seq": snap["seq"],
            "stores": len(snap.get("stores", [])),
            "idem_entries": len(snap.get("idem", [])),
            "t_wall": snap.get("t_wall"),
            "bytes": os.path.getsize(snap_path) + slab_bytes,
        },
        "records": len(records),
        "seq_range": ([records[0]["seq"], records[-1]["seq"]]
                      if records else None),
        "per_verb": dict(sorted(per_verb.items())),
        "per_store": dict(sorted(per_store.items())),
        "torn_tail": n_torn,
        "wal_bytes": (os.path.getsize(wal_path)
                      if os.path.exists(wal_path) else 0),
    }
