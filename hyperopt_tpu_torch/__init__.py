"""hyperopt_tpu_torch: the PyTorch/CUDA port of ``hyperopt_tpu``.

The same public surface for the hosted TPE run — ``fmin``, the ``hp.*``
search-space DSL, ``tpe``/``rand`` suggest algorithms, ``Trials`` — with
the numeric core in PyTorch and the EI scoring of the TPE step in CUDA
kernels written for the H100 (``ops/ei_scores.py``), the history kept
resident on the device (``history.py``).  Device mode (``device.py``:
``fmin(mode="device")``, ``fmin_device``) runs the whole loop on the
device as CUDA-graph replays of the TPE step; the fleet (``fleet.py``:
``fmin_fleet``, ``fmin_device(n_runs=)``, ``CohortScheduler``) runs many
experiments as the lanes of one step.  ``obs`` holds the observability
layer (events, metrics, ``fmin(trace_dir=)`` with ``torch.profiler``,
health, bundles, device-mode telemetry) and ``faults`` the seeded fault
points.  ``fmin(overlap_depth=, evaluators=)`` runs the pipelined loop
(``pipeline.py``: suggests in flight on the card while objectives run),
and ``PoolTrials`` (``parallel/``) evaluates trials in threads or forked
children.  Beside TPE (factorized or ``multivariate``, ``suggest_quantile``,
``startup="qmc"``) sit ``qmc`` (Sobol/Halton suggest) and the space tools:
``criteria``, ``rdists``, ``pyll`` (``pyll_shim``), ``graphviz`` and
``plotting``.  The other suggest heads are ``anneal``, ``mix``, ``atpe`` and,
under ``backends``, the GP and ES heads with the backend registry: ``fmin``
takes ``algo="<name>"`` for any name ``backends.names()`` lists.
``dispatch`` is the one substrate of every suggest path: with a
``torch.distributed`` mesh registered (``parallel.multihost.initialize``)
the TPE step splits its candidates over the mesh's ranks;
``parallel.FileTrials`` and ``FileWorker`` share trials through a
directory with worker processes.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

from . import (  # noqa: F401
    anneal, atpe, backends, criteria, device, dispatch, faults, fleet,
    graphviz, history, hp, mix, obs, plotting, qmc, rand, rdists, tpe)
from .base import (  # noqa: F401
    Ctrl,
    Domain,
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATES,
    STATUS_FAIL,
    STATUS_NEW,
    STATUS_OK,
    STATUS_RUNNING,
    STATUS_STRINGS,
    STATUS_SUSPENDED,
    Trials,
    trials_from_docs,
)
from .exceptions import (  # noqa: F401
    AllTrialsFailed,
    DuplicateLabel,
    HyperoptTpuError,
    InjectedFault,
    InvalidTrial,
    TransientEvaluationError,
)
from .device import fmin_device  # noqa: F401
from .fleet import fmin_fleet  # noqa: F401
from .fmin import (  # noqa: F401
    FMinIter,
    fmin,
    fmin_pass_expr_memo_ctrl,
    generate_trials_to_calculate,
    partial,
    space_eval,
)
from .parallel import FileTrials, PoolTrials  # noqa: F401
from .scope import scope  # noqa: F401
from . import pyll_shim as pyll  # noqa: F401
from .space import Apply, CompiledSpace, compile_space  # noqa: F401
from .utils import parameter_importance  # noqa: F401
from .utils.early_stop import no_progress_loss  # noqa: F401

# ``import hyperopt_tpu_torch.pyll`` and ``from hyperopt_tpu_torch.pyll
# import scope`` resolve as for a submodule (the reference's
# ``hyperopt.pyll``).
import sys as _sys  # noqa: E402

_sys.modules[__name__ + ".pyll"] = pyll
del _sys

__all__ = [
    "fmin", "fmin_device", "fmin_fleet", "FMinIter",
    "fmin_pass_expr_memo_ctrl", "space_eval",
    "generate_trials_to_calculate", "partial",
    "hp", "tpe", "rand", "qmc", "anneal", "mix", "atpe", "backends",
    "parameter_importance", "scope", "history", "device", "fleet", "obs",
    "faults", "criteria", "rdists", "pyll", "graphviz", "plotting",
    "dispatch", "Trials", "trials_from_docs", "Domain", "Ctrl", "PoolTrials",
    "FileTrials",
    "CompiledSpace", "compile_space", "no_progress_loss",
    "STATUS_NEW", "STATUS_RUNNING", "STATUS_SUSPENDED", "STATUS_OK",
    "STATUS_FAIL", "STATUS_STRINGS",
    "JOB_STATE_NEW", "JOB_STATE_RUNNING", "JOB_STATE_DONE",
    "JOB_STATE_ERROR", "JOB_STATE_CANCEL", "JOB_STATES",
    "AllTrialsFailed", "DuplicateLabel", "HyperoptTpuError", "InvalidTrial",
    "InjectedFault", "TransientEvaluationError", "Apply",
]
