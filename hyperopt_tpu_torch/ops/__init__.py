"""Compute ops of the TPE step: plain PyTorch, plus the hand-written CUDA
EI kernel in :mod:`.ei_scores`."""

from .gmm import (  # noqa: F401
    gmm_log_qmass,
    gmm_logpdf,
    gmm_sample,
    log_ndtr_diff,
)
from .parzen import (  # noqa: F401
    fit_parzen,
    forgetting_weights,
)
