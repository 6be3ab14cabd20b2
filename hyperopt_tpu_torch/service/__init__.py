"""Suggestion-as-a-service: the multi-tenant, WAL-durable netstore with
server-side TPE, and the sharded, replicated fleet around it.

Counterpart of ``hyperopt_tpu/service``.  Layers (each usable alone):

* :mod:`.tenancy`: per-tenant tokens (timing-safe resolution) and quotas
  (concurrent claims, trials/s admission);
* :mod:`.store`: :class:`MemTrials`, the RAM store with the file store's
  claim/heartbeat/requeue verbs, a deterministic-replay clock and the
  columnar history the device ring feeds from;
* :mod:`.wal`: the write-ahead log, snapshot/compaction and the offline
  :func:`inspect`;
* :mod:`.server`: :class:`ServiceServer`, the StoreServer subclass wiring
  the three together (append-before-execute, crash recovery, server-side
  ``suggest`` logged as physical records, the cohort gate);
* :mod:`.cluster`: the pinned consistent-hash ring and :class:`ShardMap`;
* :mod:`.replica`: :class:`ShardServer` (primary/replica roles) and
  :class:`WalShipper` (snapshot+tail WAL shipping, scrub);
* :mod:`.router`: :class:`Router`, the stateless consistent-hash front
  with failover, bounded-cutover rebalance, ``shard_add``/
  ``shard_remove`` and ``map_sync`` between peer routers;
* :mod:`.autoscaler`: :class:`Autoscaler`, the SLO-burn control loop
  driving those verbs, with a WAL-durable decision log, and
  :class:`LocalSpawner`.

Run a server, a shard or a router as ``python -m
hyperopt_tpu_torch.service.{server,replica,router} --serve ...``.
"""

from .cluster import DEFAULT_VNODES, HashRing, ShardMap, key_hash
from .store import MemTrials
from .tenancy import Tenant, TenantTable, TokenBucket
from .wal import Wal, inspect, read_wal

__all__ = [
    "Autoscaler", "DEFAULT_VNODES", "HashRing", "LocalSpawner",
    "MemTrials", "Router", "ServiceServer", "ShardMap", "ShardServer",
    "Tenant", "TenantTable", "TokenBucket", "Wal", "WalShipper",
    "inspect", "key_hash", "read_wal",
]


def __getattr__(name):
    # The server classes lazily: .server/.replica/.router pull in the
    # netstore, which tenancy/wal/cluster users do not need.
    if name == "ServiceServer":
        from .server import ServiceServer
        return ServiceServer
    if name in ("ShardServer", "WalShipper"):
        from . import replica
        return getattr(replica, name)
    if name == "Router":
        from .router import Router
        return Router
    if name in ("Autoscaler", "LocalSpawner"):
        from . import autoscaler
        return getattr(autoscaler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
