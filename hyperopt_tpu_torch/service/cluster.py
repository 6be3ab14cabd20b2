"""Consistent-hash placement of ``(tenant, exp_key)`` stores on shards.

Counterpart of ``hyperopt_tpu/service/cluster.py``, placing every key on
the shard the JAX package places it on.  A fleet's unit of placement is
one ``(tenant, exp_key)`` store; the pair hashes onto a ring of virtual
nodes, ``virtual_nodes`` points per shard, and the shard owning the first
point clockwise of the key serves it.

* **Pinned hash.**  Placement uses a SHA-1 prefix, never Python's
  builtin ``hash()`` (salted per process): any process computes the same
  owner for the same key.
* **Minimal movement.**  Adding or removing one shard moves only the
  keys whose clockwise-first point changed.

:class:`ShardMap` is the wire-visible form: the ring parameters plus
each shard's primary/replica URLs, stamped with a monotonically
increasing ``version`` so that a client tells a stale map from a fresh
one.  The map is plain data; its owner mutates it under its own lock.
"""

from __future__ import annotations

import bisect
import hashlib

__all__ = ["DEFAULT_VNODES", "HashRing", "ShardMap", "key_hash"]

#: Virtual nodes per shard (the ``virtual_nodes=`` default).  64 points
#: per shard keep the per-shard key-count spread within about +-25% for
#: small fleets, at negligible ring-build cost.
DEFAULT_VNODES = 64


def _vnodes(value=None) -> int:
    return DEFAULT_VNODES if value is None else max(1, int(value))


def _h64(s: str) -> int:
    """Pinned 64-bit point: stable across processes, platforms and
    restarts (SHA-1 prefix)."""
    return int.from_bytes(hashlib.sha1(s.encode("utf-8")).digest()[:8],
                          "big")


def key_hash(tenant, exp_key: str) -> int:
    """Placement point of one ``(tenant, exp_key)`` store.  ``None``
    tenant (single-tenant fleets) hashes as the empty name, with a NUL
    separator so ``("ab", "c")`` and ``("a", "bc")`` cannot collide."""
    return _h64(f"{tenant or ''}\x00{exp_key}")


class HashRing:
    """Consistent-hash ring with virtual nodes over opaque shard ids."""

    def __init__(self, shard_ids=(), virtual_nodes: int | None = None):
        self.virtual_nodes = _vnodes(virtual_nodes)
        self._points: list = []       # sorted (point, shard_id) pairs
        self._ids: set = set()
        for sid in shard_ids:
            self.add(sid)

    @property
    def shard_ids(self) -> list:
        return sorted(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, sid) -> bool:
        return sid in self._ids

    def add(self, sid: str) -> None:
        if sid in self._ids:
            return
        self._ids.add(sid)
        for v in range(self.virtual_nodes):
            self._points.append((_h64(f"{sid}#{v}"), sid))
        self._points.sort()

    def remove(self, sid: str) -> None:
        if sid not in self._ids:
            return
        self._ids.discard(sid)
        self._points = [p for p in self._points if p[1] != sid]

    def owner_of_point(self, point: int):
        """Shard id owning ``point``: first ring point clockwise."""
        if not self._points:
            raise ValueError("empty hash ring: no shards registered")
        i = bisect.bisect_right(self._points, (point, "￿"))
        if i == len(self._points):
            i = 0                      # wrap: the ring is a circle
        return self._points[i][1]

    def owner(self, tenant, exp_key: str):
        """Shard id owning the ``(tenant, exp_key)`` store."""
        return self.owner_of_point(key_hash(tenant, exp_key))


class ShardMap:
    """The fleet topology document: ring parameters + per-shard URLs.

    ``shards`` maps shard id -> ``{"primary": url, "replica": url|None}``.
    Not thread-safe by itself: its owner serializes changes under its own
    lock; everyone else holds snapshots from :meth:`to_dict`.
    """

    def __init__(self, shards: dict, virtual_nodes: int | None = None,
                 version: int = 1, pins: dict | None = None):
        self.version = int(version)
        self.shards = {
            str(sid): {"primary": str(ent["primary"]).rstrip("/"),
                       "replica": (str(ent["replica"]).rstrip("/")
                                   if ent.get("replica") else None)}
            for sid, ent in shards.items()}
        if not self.shards:
            raise ValueError("shard map needs at least one shard")
        self.ring = HashRing(self.shards, virtual_nodes=virtual_nodes)
        # Placement pins: "<tenant>\x00<exp_key>" -> shard id, overriding
        # the ring for that one store.  The elastic-scale cutover uses
        # them as the bounded in-between state: each migrated store is
        # pinned to its destination the moment its import commits, and
        # the pin set clears atomically when the ring itself changes
        # (shard added/removed) — clients only ever see ring+pins as one
        # versioned document, so placement is never ambiguous.
        self.pins: dict = {str(k): str(v) for k, v in (pins or {}).items()
                           if str(v) in self.shards}

    @staticmethod
    def pin_key(tenant, exp_key: str) -> str:
        """Wire-safe placement key (NUL-separated, like key_hash)."""
        return f"{tenant or ''}\x00{exp_key}"

    def owner(self, tenant, exp_key: str):
        """``(shard_id, entry)`` owning the ``(tenant, exp_key)`` store."""
        sid = self.pins.get(self.pin_key(tenant, exp_key))
        if sid is None or sid not in self.shards:
            sid = self.ring.owner(tenant, exp_key)
        return sid, self.shards[sid]

    def pin(self, tenant, exp_key: str, sid: str) -> None:
        """Pin one store to ``sid`` (bounded-cutover override)."""
        if sid not in self.shards:
            raise ValueError(f"cannot pin to unknown shard {sid!r}")
        self.pins[self.pin_key(tenant, exp_key)] = sid
        self.version += 1

    def add_shard(self, sid: str, entry: dict) -> dict:
        """Grow the ring by one shard.  Existing pins are preserved —
        the migration that is about to move keys onto the new shard
        replaces them store by store, then clears them via
        :meth:`clear_pins` once the moved set is consistent."""
        sid = str(sid)
        if sid in self.shards:
            raise ValueError(f"shard {sid!r} already in the map")
        self.shards[sid] = {
            "primary": str(entry["primary"]).rstrip("/"),
            "replica": (str(entry["replica"]).rstrip("/")
                        if entry.get("replica") else None)}
        self.ring.add(sid)
        self.version += 1
        return self.shards[sid]

    def remove_shard(self, sid: str) -> None:
        """Shrink the ring by one shard (its keys must already have
        been migrated off; the map's owner enforces that ordering)."""
        sid = str(sid)
        if sid not in self.shards:
            raise ValueError(f"shard {sid!r} not in the map")
        if len(self.shards) == 1:
            raise ValueError("cannot remove the last shard")
        del self.shards[sid]
        self.ring.remove(sid)
        self.pins = {k: v for k, v in self.pins.items() if v != sid}
        self.version += 1

    def clear_pins(self) -> None:
        """Drop every placement pin (ring placement now agrees with the
        pinned placement — the migration's terminal state)."""
        if self.pins:
            self.pins = {}
            self.version += 1

    def promote(self, sid: str) -> dict:
        """Failover: the warm replica becomes the primary.  Returns the
        updated entry; raises when the shard has no replica to promote.
        """
        ent = self.shards[sid]
        if not ent["replica"]:
            raise ValueError(f"shard {sid!r} has no replica to promote")
        ent["primary"], ent["replica"] = ent["replica"], None
        self.version += 1
        return ent

    def set_primary(self, sid: str, url: str,
                    replica: str | None = None) -> dict:
        """Rebalance cutover: point the shard at a new primary process."""
        ent = self.shards[sid]
        ent["primary"] = url.rstrip("/")
        ent["replica"] = replica.rstrip("/") if replica else None
        self.version += 1
        return ent

    def to_dict(self) -> dict:
        doc = {"version": self.version,
               "virtual_nodes": self.ring.virtual_nodes,
               "shards": {sid: dict(ent)
                          for sid, ent in sorted(self.shards.items())}}
        if self.pins:
            doc["pins"] = dict(sorted(self.pins.items()))
        return doc

    @classmethod
    def from_dict(cls, doc: dict) -> "ShardMap":
        return cls(doc["shards"], virtual_nodes=doc.get("virtual_nodes"),
                   version=doc.get("version", 1), pins=doc.get("pins"))
