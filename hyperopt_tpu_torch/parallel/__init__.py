"""Trial-level parallelism on one host.

Counterpart of ``hyperopt_tpu/parallel``, for the parts ported so far:
:class:`PoolTrials` (the ``SparkTrials`` capability: trials evaluated
concurrently in threads or in killable forked children) and
:class:`CompletionQueueEvaluator` (the evaluator stage of ``fmin``'s
pipelined loop, ``pipeline.py``).  The sharded suggest, the file store and
the network store belong to later slices of the port.
"""

from .pool import CompletionQueueEvaluator, PoolTrials  # noqa: F401

__all__ = ["PoolTrials", "CompletionQueueEvaluator"]
