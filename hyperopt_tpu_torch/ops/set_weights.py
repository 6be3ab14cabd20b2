"""The TPE step's per-column observation weights of both split sets, in one
launch.

For a split set (a bool mask ``[..., N]`` over the history's rows, in
trial order) and a group's active columns ``act [..., N, C]``, an
observation of column ``c`` is in the set where both hold; its weight is
linear forgetting (``ops/parzen.py::forgetting_weights``) by its recency
rank among the set's observations of that column, and 0 elsewhere.
:func:`set_weights_reference` is the plain composition (``torch.cumsum``
of the mask along the rows, then the weights' arithmetic).

:func:`set_weights` computes both sets of a group (below, above) at once:
for CUDA tensors one launch of ``csrc/set_weights.cu`` (adding one to
``set_weights.launches``, or to ``set_weights.recorded_by`` inside a CUDA
graph capture), which writes the reference's bits; for CPU tensors the
reference, set by set.  The library is built with the EI kernels'
(``ei_scores.build``).  Replaces no TPU kernel (the source says why it
exists and what bounds it).
"""

from __future__ import annotations

import math
import threading

import torch

from . import ei_scores as _ei
from .parzen import forgetting_weights

#: Functions that run under device mode's CUDA graph capture, called
#: from another module: the capture-purity analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "set_weights",
)

_COUNT_LOCK = threading.Lock()


def set_weights_reference(set_mask, act, lf):
    """Plain PyTorch weights of one set: ``(m[..., N, C], w[..., N, C],
    n_set[..., C])``, the observations in the set, their weights (float32,
    0 outside the set) and their count (int64)."""
    m = set_mask[..., None] & act
    n_set = torch.sum(m, dim=-2)
    rank_in = torch.cumsum(m.to(torch.int64), dim=-2) - 1
    w = forgetting_weights(rank_in, n_set[..., None, :], lf)
    return m, torch.where(m, w, torch.zeros_like(w)), n_set


def set_weights(below, above, act, lf):
    """Weights of the two split sets ``below`` and ``above`` (bool
    ``[..., N]``) over the active columns ``act`` (bool ``[..., N, C]``,
    the same leading shape) at forgetting horizon ``lf``:
    ``((m, w, n_set) of below, (m, w, n_set) of above)``, each as
    :func:`set_weights_reference` gives it.

    CUDA tensors launch the kernel once, or raise; CPU tensors take the
    reference.  Inside a CUDA-graph capture the launch is recorded into
    the graph: it adds to ``set_weights.recorded_by``, not
    ``set_weights.launches``, and replays pass through neither."""
    for name, t in (("below", below), ("above", above)):
        if t.shape != act.shape[:-1]:
            raise ValueError(f"{name} must be {tuple(act.shape[:-1])}, got "
                             f"{tuple(t.shape)}")
        if t.device != act.device:
            raise ValueError(f"{name} is on {t.device}, act on {act.device}")
    if act.device.type == "cpu":
        return tuple(set_weights_reference(s, act, lf)
                     for s in (below, above))
    if act.device.type != "cuda":
        raise ValueError(f"set_weights runs on cuda or cpu, not "
                         f"{act.device}")
    if not torch.cuda.is_available():
        raise RuntimeError("set_weights got CUDA tensors but CUDA is not "
                           "available")
    for t in (below, above, act):
        if t.dtype != torch.bool:
            raise TypeError(f"set_weights kernel takes bool masks, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("set_weights kernel takes contiguous tensors")
    if "set_weights" not in _ei._libs:
        _ei.build()
    *lead, n, c = act.shape
    lanes = math.prod(lead)
    m = torch.empty((2, *act.shape), dtype=torch.bool, device=act.device)
    w = torch.empty((2, *act.shape), dtype=torch.float32, device=act.device)
    n_set = torch.empty((2, *lead, c), dtype=torch.int64, device=act.device)
    if lanes * c > 2 ** 31 - 1:
        raise ValueError(f"{lanes} lanes x {c} columns exceed one launch's "
                         f"blocks")
    if lanes * c:
        with torch.cuda.device(act.device):
            recording = torch.cuda.is_current_stream_capturing()
            _launch(below, above, act, m, w, n_set, lanes, n, c, lf)
        with _COUNT_LOCK:
            if recording:
                set_weights.recorded_by += 1
            else:
                set_weights.launches += 1
    return (m[0], w[0], n_set[0]), (m[1], w[1], n_set[1])


set_weights.launches = 0
set_weights.recorded_by = 0


def _launch(below, above, act, m, w, n_set, lanes, n, c, lf):
    """One launch of ``set_weights_launch`` on the current stream; raises
    when CUDA refuses it."""
    stream = torch.cuda.current_stream().cuda_stream
    err = _ei._libs["set_weights"].set_weights_launch(
        below.data_ptr(), above.data_ptr(), act.data_ptr(), m.data_ptr(),
        w.data_ptr(), n_set.data_ptr(), int(lanes), int(n), int(c),
        float(lf), stream)
    if err != 0:
        raise RuntimeError(f"set_weights kernel launch failed: CUDA error "
                           f"{err}")


def reset_launches():
    """Set ``set_weights.launches`` and ``set_weights.recorded_by`` to 0."""
    with _COUNT_LOCK:
        set_weights.launches = 0
        set_weights.recorded_by = 0
