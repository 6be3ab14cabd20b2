"""The service tier's host-side building blocks.

Counterpart of ``hyperopt_tpu/service``, for the parts ported so far:

* :mod:`.tenancy`: per-tenant tokens (timing-safe resolution) and quotas
  (concurrent claims, trials/s admission), which
  :class:`~hyperopt_tpu_torch.parallel.netstore.StoreServer` takes as
  ``tenants=``;
* :mod:`.cluster`: the pinned consistent-hash ring and :class:`ShardMap`,
  placing each ``(tenant, exp_key)`` store on the shard the JAX package
  places it on.

The RAM store, the write-ahead log, the service server, replicas, the
router and the autoscaler belong to a later slice of the port.
"""

from .cluster import DEFAULT_VNODES, HashRing, ShardMap, key_hash
from .tenancy import Tenant, TenantTable, TokenBucket

__all__ = ["DEFAULT_VNODES", "HashRing", "ShardMap", "Tenant", "TenantTable",
           "TokenBucket", "key_hash"]
