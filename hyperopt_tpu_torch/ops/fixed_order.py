"""Float sums of the TPE step in a fixed order of additions.

PyTorch's reductions and scans pick their CUDA launch shape from the whole
tensor: the number of rows, a row's alignment in memory, whether it is the
only row.  A row's sum can then round differently when the same row sits
in a taller batch.  The fleet (``fleet.py``, ``device.py`` with lanes)
stacks L experiments along a leading axis of the one TPE step, and lane
``j`` must propose exactly what the same experiment proposes alone; so
every float sum of the step runs here, as a tree of elementwise adds whose
pairing depends on the length of the summed axis only: the same bits for
any number of rows, on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Functions that run under device mode's CUDA graph capture, called
#: from another module: the capture-purity analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "tree_sum",
    "tree_logsumexp",
    "prefix_sum",
)


def _pad_dim(x, dim, before, after):
    """Zero-pad ``x`` along ``dim`` (``before``/``after`` elements)."""
    pad = [0, 0] * (x.dim() - 1 - dim) + [before, after]
    return F.pad(x, pad)


def tree_sum(x, dim=-1, keepdim=False):
    """Sum along ``dim`` as a balanced tree: zero-pad to a power of two,
    then add the upper half onto the lower half until one element is left
    (element ``i`` pairs with ``i + h``)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = _pad_dim(x, dim, 0, p - n)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x if keepdim else x.squeeze(dim)


def tree_logsumexp(x, dim=-1):
    """``log Σ exp(x)`` along ``dim`` with :func:`tree_sum`; the semantics
    of ``torch.logsumexp`` (an infinite max is shifted by 0: all ``-inf``
    gives ``-inf``, a ``+inf`` gives ``+inf``)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    s = tree_sum(torch.exp(x - m), dim, keepdim=True)
    return (torch.log(s) + m).squeeze(dim)


def prefix_sum(x, dim=-1):
    """Inclusive prefix sum along ``dim`` (Hillis–Steele: at step ``s``,
    element ``i >= s`` adds element ``i - s``)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    s = 1
    while s < n:
        x = x + _pad_dim(x.narrow(dim, 0, n - s), dim, s, 0)
        s <<= 1
    return x
