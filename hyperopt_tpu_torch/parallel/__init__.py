"""Parallel execution: the sharded suggest, trial-level parallelism, the
file store and the network store.

Counterpart of ``hyperopt_tpu/parallel``, for the parts ported so far:

* the mesh (``dispatch.py``, re-exported by :mod:`.sharded`):
  :class:`ShardedTpeKernel`, :func:`default_mesh`,
  :func:`sharded_suggest` (candidates split over a ``torch.distributed``
  mesh) and :func:`multi_start_suggest` (K posteriors in one step, lanes
  over the mesh's ``dp`` axis);
* :class:`PoolTrials` (trials evaluated in threads or forked children) and
  :class:`CompletionQueueEvaluator` (the evaluator stage of ``fmin``'s
  pipelined loop);
* :class:`FileTrials` and :class:`FileWorker` (:mod:`.filestore`: a
  durable store on a shared directory, evaluated by worker processes);
* :class:`StoreServer`, :class:`NetTrials` and :class:`NetWorker`
  (:mod:`.netstore`: the file store served over HTTP, with server-side
  suggest), and :class:`RouterTrials` (a ``NetTrials`` placed through a
  fleet router, ``service/router.py``);
* :mod:`.multihost` (driver and worker roles over either store).
"""

from .filestore import FileTrials, FileWorker  # noqa: F401
from .netstore import (  # noqa: F401
    NetTrials,
    NetWorker,
    RouterTrials,
    StoreServer,
)
from .pool import CompletionQueueEvaluator, PoolTrials  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedTpeKernel,
    default_mesh,
    multi_start_suggest,
    sharded_suggest,
)

__all__ = ["PoolTrials", "CompletionQueueEvaluator", "FileTrials",
           "FileWorker", "NetTrials", "NetWorker", "RouterTrials", "StoreServer",
           "ShardedTpeKernel", "default_mesh", "multi_start_suggest",
           "sharded_suggest"]
