"""Device-resident history ring: O(P) host→device bytes per trial.

Counterpart of the single-experiment store of ``hyperopt_tpu/history.py``.
Without it, ``tpe.suggest_dispatch`` pads the whole history on the host
(:func:`_padded_history`) and uploads ``n_cap × P`` values every step for
a delta of one row.  This module keeps the padded ``(vals, active, loss,
ok)`` tensors resident on the device, one set per ``(trials, space,
device)``, with an append cursor:

* **Append**: only the rows completed since the last call cross to the
  device, written in place after the resident ones.
* **Coherence**: the ring remembers the tids of the rows it holds.  When
  they are no longer a prefix of the history's tids (a deleted or
  inserted trial), the ring takes ONE full re-upload, counted in
  ``rebuilds``; a history that holds every resident tid but in another
  order raises :class:`HistoryOrderError` instead.
* **Growth**: a device pad-copy to the next power-of-two capacity, zero
  host→device bytes; :func:`pregrow` does it ahead of the bucket flip.
* **In-flight fantasies**: constant-liar rows of NEW/RUNNING trials go
  into the slack rows past the real ones of a COPY, so the resident
  tensors stay clean for the next append.

The tensors returned are bit-identical to :func:`_padded_history` of the
same history (plus the fantasy rows), so the ring is a transfer path, not
a change of math.  ``tpe.suggest_dispatch`` feeds from it unless called
with ``resident=False``.

Counters (plain ints, like ``ei_scores.launches``): ``upload_bytes``
(every host→device byte this module moves), ``append_hits`` (calls served
by the delta path), ``rebuilds`` (full re-uploads).
"""

from __future__ import annotations

import math
import threading
import weakref

import numpy as np
import torch

__all__ = ["device_history", "pregrow", "forget", "generation",
           "HistoryOrderError", "upload_bytes", "append_hits", "rebuilds"]

upload_bytes = 0
append_hits = 0
rebuilds = 0


def _row_bytes(p: int) -> int:
    """Host→device bytes per history row: f32 vals, bool active, f32 loss,
    bool ok."""
    return p * 4 + p + 4 + 1


class HistoryOrderError(RuntimeError):
    """The trials log reordered rows the resident ring already holds.

    Completed trials are append-only in tid order; a silent rebuild on a
    reorder would hide whatever scrambled the log.  Raised only when every
    resident tid is still present in another relative order: a deleted
    row or a late completion inserted mid-history rebuilds instead."""


class _Resident:
    """Resident tensors for one (trials, space, device)."""

    __slots__ = ("cs", "cap", "n", "tids", "bufs")

    def __init__(self, cs, cap, n, tids, bufs):
        self.cs = cs        # strong ref: pins id(cs) while this entry lives
        self.cap = cap      # capacity, monotone within an entry
        self.n = n          # real rows resident
        self.tids = tids    # i64[n], the tids of those rows
        self.bufs = bufs    # (vals, active, loss, ok) tensors [cap, ...]


# trials -> {(id(cs), device): _Resident}, weak on the trials object so a
# finished experiment's tensors free with it.
_STORE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# trials -> wipe generation, bumped by forget().
_GENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LOCK = threading.Lock()


def generation(trials) -> int:
    """How many times :func:`forget` wiped ``trials``."""
    try:
        return _GENS.get(trials, 0)
    except TypeError:
        return 0


def forget(trials):
    """Drop the resident tensors of ``trials`` and bump its generation.
    Ordinary mutation needs no call: the tids check catches it."""
    with _LOCK:
        try:
            _STORE.pop(trials, None)
            _GENS[trials] = _GENS.get(trials, 0) + 1
        except TypeError:
            pass


def _states(trials):
    try:
        with _LOCK:
            return _STORE.setdefault(trials, {})
    except TypeError:       # a trials object without weakref support
        return None


def _device(cs, device):
    if device is not None:
        return torch.device(device)
    from .space import resolve_device

    return resolve_device(cs.device)


def _padded_history(h, n_cap):
    """Host arrays of the history ``h`` padded to ``n_cap`` rows: 0 vals,
    False active, +inf loss, False ok past the real rows (the layout of
    the ring's tensors)."""
    n, p = h["vals"].shape
    vals = np.zeros((n_cap, p), np.float32)
    active = np.zeros((n_cap, p), bool)
    loss = np.full((n_cap,), np.inf, np.float32)
    ok = np.zeros((n_cap,), bool)
    vals[:n] = h["vals"]
    active[:n] = h["active"]
    loss[:n] = h["loss"]
    ok[:n] = h["ok"]
    return vals, active, loss, ok


def _put(arrs, dev):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                 for a in arrs)


def _grow(bufs, cap):
    """Pad-copy to capacity ``cap`` with :func:`_padded_history`'s pad
    values."""
    hv, ha, hl, hok = bufs
    pad = cap - hv.shape[0]
    return (torch.cat([hv, hv.new_zeros((pad, hv.shape[1]))]),
            torch.cat([ha, ha.new_zeros((pad, ha.shape[1]))]),
            torch.cat([hl, hl.new_full((pad,), math.inf)]),
            torch.cat([hok, hok.new_zeros((pad,))]))


def _coherent(st, cs, h, p):
    return (st is not None and st.cs is cs
            and st.bufs[0].shape[1] == p
            and st.n <= h["tids"].shape[0]
            and np.array_equal(st.tids, h["tids"][: st.n]))


def _check_tid_order(st, cs, h, p):
    """Raise :class:`HistoryOrderError` on a true reorder; return on the
    legitimate causes of a rebuild."""
    if st is None or st.cs is not cs or st.bufs[0].shape[1] != p \
            or st.n == 0:
        return
    pos = {int(t): i for i, t in enumerate(np.asarray(h["tids"]).tolist())}
    idxs = [pos.get(int(t)) for t in np.asarray(st.tids).tolist()]
    if any(ix is None for ix in idxs):
        return      # resident rows vanished: rebuild
    if all(b > a for a, b in zip(idxs, idxs[1:])):
        return      # still a subsequence (a mid-history insert): rebuild
    raise HistoryOrderError(
        f"resident history rows appended out of tid order: the trials log "
        f"still holds all {st.n} resident tids but permuted them (first "
        f"rows now at log positions {idxs[:8]}...)")


def device_history(trials, cs, h, n_cap, fantasies=None, device=None):
    """``(vals, active, loss, ok)`` tensors on the device, bit-identical
    to ``_padded_history(h, n_cap)`` (plus the fantasy rows),
    uploading only the rows added since the last call.

    ``h`` is ``trials.history(cs)``.  ``fantasies`` is ``(pv f32[M, P],
    pa bool[M, P], lie)``: rows ``[n, n + M)`` of a copy get them, with
    loss ``lie`` and ok True.  ``device`` defaults to ``cs.device``.  The
    tensors returned (without fantasies) are the ring's own, or a view of
    them: read them, do not write them."""
    global upload_bytes, append_hits, rebuilds
    n, p = h["vals"].shape
    if n > n_cap:
        raise ValueError(f"{n} history rows do not fit n_cap={n_cap}")
    dev = _device(cs, device)
    states = _states(trials)
    key = (id(cs), str(dev))
    with _LOCK:
        st = states.get(key) if states is not None else None
        if not _coherent(st, cs, h, p):
            _check_tid_order(st, cs, h, p)
            cap = max(n_cap, st.cap if st is not None else 0)
            st = _Resident(cs, cap, n, h["tids"], _put(_padded_history(h, cap),
                                                       dev))
            if states is not None:
                states[key] = st
            rebuilds += 1
            upload_bytes += cap * _row_bytes(p)
        else:
            if n_cap > st.cap:
                st.bufs = _grow(st.bufs, n_cap)
                st.cap = n_cap
            if n > st.n:
                hv, ha, hl, hok = st.bufs
                sl = slice(st.n, n)
                rows = _put((h["vals"][sl], h["active"][sl], h["loss"][sl],
                             h["ok"][sl]), dev)
                for buf, rows_k in zip(st.bufs, rows):
                    buf[sl] = rows_k
                upload_bytes += (n - st.n) * _row_bytes(p)
                st.n = n
                st.tids = h["tids"]
            append_hits += 1
        out = st.bufs
    if st.cap > n_cap:
        out = tuple(b[:n_cap] for b in out)
    if fantasies is not None and len(fantasies[0]):
        pv, pa, lie = fantasies
        m = len(pv)
        if n + m > n_cap:
            raise ValueError(f"{m} fantasy rows after {n} rows do not fit "
                             f"n_cap={n_cap}")
        hv, ha, hl, hok = (b.clone() for b in out)
        pv_t, pa_t = _put((pv, pa), dev)
        hv[n:n + m] = pv_t
        ha[n:n + m] = pa_t
        hl[n:n + m] = float(np.float32(lie))
        hok[n:n + m] = True
        upload_bytes += m * (p * 4 + p)
        out = (hv, ha, hl, hok)
    return out


def pregrow(trials, cs, n_cap, device=None):
    """Pad-copy the resident tensors to ``n_cap`` ahead of the bucket flip
    (device work only, no host→device bytes).  No-op when the ring is cold
    or already that big."""
    states = _states(trials)
    if states is None:
        return
    dev = _device(cs, device)
    with _LOCK:
        st = states.get((id(cs), str(dev)))
        if st is None or st.cap >= n_cap:
            return
        st.bufs = _grow(st.bufs, n_cap)
        st.cap = n_cap
