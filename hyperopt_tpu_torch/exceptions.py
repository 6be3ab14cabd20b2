"""Exception types.

Reference parity: ``hyperopt/exceptions.py`` (AllTrialsFailed, InvalidTrial,
DuplicateLabel; mount was empty — anchors per SURVEY.md §2).
"""


class HyperoptTpuError(Exception):
    """Base class for all framework errors."""


class AllTrialsFailed(HyperoptTpuError):
    """Raised when ``fmin`` finishes without a single successful trial."""


class InvalidTrial(HyperoptTpuError):
    """A trial document failed schema validation."""


class InvalidResultStatus(HyperoptTpuError):
    """Objective returned a result dict with an unknown ``status``."""


class InvalidLoss(HyperoptTpuError):
    """Objective returned a non-finite / non-float loss with status ok."""


class DuplicateLabel(HyperoptTpuError):
    """The same hyperparameter label was used twice in one search space."""


class InvalidAnnotatedParameter(HyperoptTpuError):
    """A search-space leaf is not a recognized hyperparameter expression."""


class InjectedFault(HyperoptTpuError):
    """A seeded fault fired at a named fault point (``faults.py``).

    Always deliberate — raised only when a fault schedule is armed, never
    by production code paths.  Carries the fault-point name so retry logic
    and chaos tests can attribute the failure.
    """

    def __init__(self, point, call_no=None):
        self.point = point
        self.call_no = call_no
        suffix = f" (call #{call_no})" if call_no is not None else ""
        super().__init__(f"injected fault at {point!r}{suffix}")


class TransientEvaluationError(HyperoptTpuError):
    """An objective failure the caller believes is worth retrying.

    Raise this (or a subclass) from an objective to ask the trial loop to
    re-run the same point, subject to the ``max_trial_retries`` budget.
    """


class QuotaExceeded(HyperoptTpuError):
    """A tenant exceeded one of its service quotas (max concurrent claims
    or trials/s admission rate) and the server refused the verb.

    Deliberately NOT transient: a caller looping on quota rejections is
    over its budget by construction — backing off blindly would mask
    starvation.  Callers that can wait should sleep past the refill
    window and retry explicitly.
    """


class Backpressure(HyperoptTpuError):
    """The service is shedding load and asks the caller to come back later.

    Unlike :class:`QuotaExceeded` (a per-tenant budget the caller is over
    by construction), backpressure is a *fleet* condition: the autoscaler
    tightened admission because capacity cannot grow fast enough.  The
    server names its own price — ``retry_after_s`` — and well-behaved
    clients (``_Rpc`` / ``RouterTrials``) sleep a jittered fraction of it
    and retry WITHOUT burning their transport retry budget: the bytes
    made it there and back, the server just said "not yet".
    """

    def __init__(self, message, retry_after_s=1.0):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message)


class ShardFenced(HyperoptTpuError):
    """The shard (or one store on it) is fenced for a topology change.

    A typed retriable *redirect*, not a failure: the verb reached a
    server that is mid-cutover (rebalance, promotion, or a per-store
    migration) and deliberately refused it so the moving state stays
    quiesced.  A routed client (``_RoutedRpc``) reacts by forcing a
    shard-map refresh and retrying against the new owner; a direct
    client sees it surface after the transport retry budget because a
    fence does not lift by itself — the *map* changes instead.
    """


class NetstoreUnavailable(HyperoptTpuError):
    """Netstore transport failure that survived the whole retry budget.

    Distinct from server-*reported* errors (which stay ``RuntimeError``:
    the server was reachable and answered with a fault of its own).  This
    one means the bytes never made it there and back.
    """

    def __init__(self, message, attempts=None):
        self.attempts = attempts
        super().__init__(message)


#: Exception classes the trial loop treats as retryable without charging
#: the trial a permanent failure.  Deliberately narrow: an arbitrary
#: objective bug must NOT burn retry budget looping on itself.
TRANSIENT_ERRORS = (InjectedFault, TransientEvaluationError,
                    NetstoreUnavailable)


def is_transient(exc):
    """True when ``exc`` is an error the retry budget should absorb."""
    return isinstance(exc, TRANSIENT_ERRORS)


#: The same classification by exception *type name* — for recovery paths
#: where only the marshalled name survives (a forked evaluation child
#: reports ``(type_name, message)`` over its pipe, not the object).
TRANSIENT_ERROR_NAMES = frozenset(c.__name__ for c in TRANSIENT_ERRORS)
