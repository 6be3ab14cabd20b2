"""hyperopt_tpu_torch: the PyTorch/CUDA port of ``hyperopt_tpu``.

The same public surface for the hosted TPE run — ``fmin``, the ``hp.*``
search-space DSL, ``tpe``/``rand`` suggest algorithms, ``Trials`` — with
the numeric core in PyTorch and the EI scoring of the TPE step in CUDA
kernels written for the H100 (``ops/ei_scores.py``), the history kept
resident on the device (``history.py``).  Device mode (``device.py``:
``fmin(mode="device")``, ``fmin_device``) runs the whole loop on the
device as CUDA-graph replays of the TPE step; the fleet (``fleet.py``:
``fmin_fleet``, ``fmin_device(n_runs=)``, ``CohortScheduler``) runs many
experiments as the lanes of one step.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from . import device, fleet, history, hp, rand, tpe  # noqa: F401
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
from .exceptions import AllTrialsFailed, DuplicateLabel  # noqa: F401
from .device import fmin_device  # noqa: F401
from .fleet import fmin_fleet  # noqa: F401
from .fmin import (  # noqa: F401
    FMinIter,
    fmin,
    generate_trials_to_calculate,
    space_eval,
)
from .scope import scope  # noqa: F401
from .space import CompiledSpace, compile_space  # noqa: F401
from .utils.early_stop import no_progress_loss  # noqa: F401

__all__ = [
    "fmin", "fmin_device", "fmin_fleet", "FMinIter", "space_eval", "generate_trials_to_calculate",
    "hp", "tpe", "rand", "scope", "history", "device", "fleet",
    "Trials", "trials_from_docs", "Domain", "Ctrl",
    "CompiledSpace", "compile_space", "no_progress_loss",
    "STATUS_NEW", "STATUS_RUNNING", "STATUS_SUSPENDED", "STATUS_OK",
    "STATUS_FAIL", "STATUS_STRINGS",
    "JOB_STATE_NEW", "JOB_STATE_RUNNING", "JOB_STATE_DONE",
    "JOB_STATE_ERROR", "JOB_STATE_CANCEL", "JOB_STATES",
    "AllTrialsFailed", "DuplicateLabel",
]
