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
* **Bounded residency**: ``device_history(..., lru_cap=k)`` keeps at most
  ``k`` rings over the calls that pass a cap, the least recently used
  evicted first (counted in ``evicted``); ``lru_cap=0`` (the default)
  keeps all.
* **Cohorts** (the fleet half, ``fleet.CohortScheduler``): a
  :class:`BatchedResident` stacks one ring per experiment along a leading
  lane axis, ``[B, cap, ...]``, fed by :func:`device_history_batched`
  with the same delta-append and coherence rules per lane, plus a wipe
  generation per lane (:func:`generation`) and the :data:`KEEP` marker for
  a lane whose experiment sits out a dispatch.

The tensors returned are bit-identical to :func:`_padded_history` of the
same history (plus the fantasy rows), so the ring is a transfer path, not
a change of math.  ``tpe.suggest_dispatch`` feeds from it unless called
with ``resident=False``.

Counters (plain ints, like ``ei_scores.launches``): ``upload_bytes``
(every host→device byte this module moves), ``append_hits`` (calls or
cohort lanes served by the delta path), ``rebuilds`` (full re-uploads of a
ring or a lane), ``evicted`` (rings dropped by the LRU cap).
"""

from __future__ import annotations

import math
import threading
import weakref
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["device_history", "pregrow", "forget", "generation",
           "HistoryOrderError", "BatchedResident", "device_history_batched",
           "pregrow_batched", "KEEP", "upload_bytes", "append_hits",
           "rebuilds", "evicted"]

upload_bytes = 0
append_hits = 0
rebuilds = 0
evicted = 0


class _Keep:
    """Lane marker for :func:`device_history_batched`: the lane belongs to
    a live experiment that is not part of this dispatch; its resident rows
    and cursor stay as they are (its output lane is unused)."""

    __slots__ = ()

    def __repr__(self):
        return "history.KEEP"


KEEP = _Keep()


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
# The rings touched by calls with an lru_cap, (weakref(trials), inner
# key) -> None, hottest last: the order the cap evicts in.
_LRU: "OrderedDict" = OrderedDict()
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
            ref = weakref.ref(trials)
            for k in [k for k in _LRU if k[0] == ref or k[0]() is None]:
                del _LRU[k]
            _STORE.pop(trials, None)
            _GENS[trials] = _GENS.get(trials, 0) + 1
        except TypeError:
            pass


def _lru_touch(trials, key, cap):
    """Mark ``(trials, key)`` most recently used and drop the coldest rings
    past ``cap``.  Caller holds ``_LOCK``."""
    global evicted
    try:
        ref = weakref.ref(trials)
    except TypeError:
        return
    _LRU[(ref, key)] = None
    _LRU.move_to_end((ref, key))
    while len(_LRU) > cap:
        (ref, k), _ = _LRU.popitem(last=False)
        owner = ref()
        if owner is None:
            continue        # its trials died, and its ring with it
        states = _STORE.get(owner)
        if states is not None and states.pop(k, None) is not None:
            evicted += 1


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


def device_history(trials, cs, h, n_cap, fantasies=None, device=None,
                   lru_cap=0):
    """``(vals, active, loss, ok)`` tensors on the device, bit-identical
    to ``_padded_history(h, n_cap)`` (plus the fantasy rows),
    uploading only the rows added since the last call.

    ``h`` is ``trials.history(cs)``.  ``fantasies`` is ``(pv f32[M, P],
    pa bool[M, P], lie)``: rows ``[n, n + M)`` of a copy get them, with
    loss ``lie`` and ok True.  ``device`` defaults to ``cs.device``.
    ``lru_cap > 0`` keeps at most that many rings resident over the calls
    that pass a cap (least recently used out first).  The tensors returned
    (without fantasies) are the ring's own, or a view of them: read them,
    do not write them."""
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
        if states is not None and lru_cap:
            _lru_touch(trials, key, int(lru_cap))
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


# ---------------------------------------------------------------------------
# the fleet half: stacked rings of a cohort
# ---------------------------------------------------------------------------


class BatchedResident:
    """Stacked device rings for a cohort of experiments: one set of
    ``[B, cap, ...]`` tensors, one lane per experiment, owned by its
    ``fleet.CohortScheduler`` cohort.  Per-lane cursors (``n``), tids
    fingerprints and wipe generations drive the delta-append and
    coherence rules of the solo ring, lane by lane."""

    __slots__ = ("b", "cap", "p", "device", "n", "tids", "gens", "filled",
                 "bufs")

    def __init__(self, b: int, cap: int, p: int, device):
        self.b = b
        self.cap = cap
        self.p = p
        self.device = device
        self.n = [0] * b            # real rows resident per lane
        self.tids = [None] * b      # per-lane coherence fingerprint
        self.gens = [0] * b         # per-lane wipe generation
        self.filled = [False] * b   # the lane ever held real rows
        dev = torch.device(device)
        self.bufs = (torch.zeros((b, cap, p), dtype=torch.float32, device=dev),
                     torch.zeros((b, cap, p), dtype=torch.bool, device=dev),
                     torch.full((b, cap), math.inf, dtype=torch.float32,
                                device=dev),
                     torch.zeros((b, cap), dtype=torch.bool, device=dev))

    def nbytes(self) -> int:
        """Device bytes of the stacked rings."""
        return sum(t.numel() * t.element_size() for t in self.bufs)


def _lane_coherent(st, i, h, gen):
    return (st.tids[i] is not None and st.gens[i] == gen
            and st.n[i] <= h["tids"].shape[0]
            and np.array_equal(st.tids[i], h["tids"][: st.n[i]]))


def _grow_batched(bufs, cap):
    """Pad-copy stacked rings to capacity ``cap`` (the pad values of
    :func:`_padded_history`)."""
    hv, ha, hl, hok = bufs
    b, pad = hv.shape[0], cap - hv.shape[1]
    return (torch.cat([hv, hv.new_zeros((b, pad, hv.shape[2]))], dim=1),
            torch.cat([ha, ha.new_zeros((b, pad, ha.shape[2]))], dim=1),
            torch.cat([hl, hl.new_full((b, pad), math.inf)], dim=1),
            torch.cat([hok, hok.new_zeros((b, pad))], dim=1))


def device_history_batched(store, lanes, n_cap, fantasies=None, gens=None,
                           device=None):
    """The history feed of one cohort: ``(store, bufs)`` with ``bufs =
    (hv[B, n_cap, P], ha, hl[B, n_cap], hok)`` whose lane ``i`` is
    bit-identical to ``_padded_history(lanes[i], n_cap)`` (plus that
    lane's constant-liar rows).

    ``lanes`` holds ``B`` ``Trials.history()`` dicts; ``None`` marks a
    padding lane (an empty history: a lane that held rows is cleared on
    the device) and :data:`KEEP` an occupied lane whose experiment sits
    out this dispatch (left untouched).  ``store`` is the
    :class:`BatchedResident` the previous call returned for this cohort,
    or None; a new lane count, parameter width or device starts a new
    one, a larger capacity is a device pad-copy (a smaller one is served
    from the first ``n_cap`` rows),
    and a coherent lane uploads only its new rows.  ``fantasies`` is a
    list of ``B`` entries, each None, a ``(pv, pa, lie)`` tuple or a list
    of them (slots laid out from the lane's last row on, clipped to the
    bucket), written into a copy; the store's rings stay clean.
    ``gens`` holds each lane's :func:`generation`: a lane whose
    generation moved (its trials was wiped) is uploaded whole even when
    reused tids happen to match.  ``device`` defaults to the store's, and
    for a new store to CUDA."""
    global upload_bytes, append_hits, rebuilds
    b = len(lanes)
    if gens is None:
        gens = [0] * b
    real = [h for h in lanes if isinstance(h, dict)]
    if not real:
        raise ValueError("device_history_batched: every lane is padding")
    p = real[0]["vals"].shape[1]
    if device is not None:
        dev = torch.device(device)
    elif store is not None:
        dev = store.device
    else:
        from .space import resolve_device

        dev = resolve_device(None)
    if (store is None or store.b != b or store.p != p
            or str(store.device) != str(dev)):
        store = BatchedResident(b, n_cap, p, dev)
    elif store.cap < n_cap:
        store.bufs = _grow_batched(store.bufs, n_cap)
        store.cap = n_cap
    cap = store.cap
    for i, h in enumerate(lanes):
        if h is KEEP:
            continue
        if h is None:
            if store.filled[i]:
                hv, ha, hl, hok = store.bufs
                hv[i] = 0.0
                ha[i] = False
                hl[i] = math.inf
                hok[i] = False
                store.n[i], store.tids[i] = 0, None
                store.filled[i] = False
            store.gens[i] = gens[i]
            continue
        n = h["vals"].shape[0]
        if n > cap:
            raise ValueError(f"{n} history rows do not fit n_cap={cap}")
        if _lane_coherent(store, i, h, gens[i]):
            if n > store.n[i]:
                sl = slice(store.n[i], n)
                rows = _put((h["vals"][sl], h["active"][sl], h["loss"][sl],
                             h["ok"][sl]), dev)
                for buf, rows_k in zip(store.bufs, rows):
                    buf[i, sl] = rows_k
                upload_bytes += (n - store.n[i]) * _row_bytes(p)
            append_hits += 1
        else:
            # First touch, a prefix mismatch or a wipe: the whole lane,
            # padded to the capacity (which also clears stale rows).
            for buf, rows_k in zip(store.bufs,
                                   _put(_padded_history(h, cap), dev)):
                buf[i] = rows_k
            rebuilds += 1
            upload_bytes += cap * _row_bytes(p)
        store.n[i], store.tids[i] = n, h["tids"]
        store.gens[i] = gens[i]
        store.filled[i] = store.filled[i] or n > 0
    out = store.bufs
    if cap > n_cap:
        out = tuple(t[:, :n_cap] for t in out)
    if fantasies is not None and any(f is not None for f in fantasies):
        out = _overlay_batched(out, lanes, fantasies, n_cap, p, dev)
    return store, out


def _overlay_batched(bufs, lanes, fantasies, n_cap, p, dev):
    """Each lane's constant-liar slots, laid out from its last real row on
    and clipped to the bucket, in a copy of the stacked rings."""
    global upload_bytes
    out = None
    for i, f in enumerate(fantasies):
        if f is None:
            continue
        pos = lanes[i]["vals"].shape[0] if isinstance(lanes[i], dict) else 0
        for pv, pa, lie in (f if isinstance(f, list) else [f]):
            m = min(len(pv), n_cap - pos)
            if m <= 0:
                continue
            if out is None:
                out = tuple(t.clone() for t in bufs)
            hv, ha, hl, hok = out
            pv_t, pa_t = _put((np.asarray(pv, np.float32)[:m],
                               np.asarray(pa, bool)[:m]), dev)
            hv[i, pos:pos + m] = pv_t
            ha[i, pos:pos + m] = pa_t
            hl[i, pos:pos + m] = float(np.float32(lie))
            hok[i, pos:pos + m] = True
            upload_bytes += m * (p * 4 + p)
            pos += m
    return bufs if out is None else out


def pregrow_batched(store, n_cap):
    """Pad-copy a cohort's stacked rings to ``n_cap`` ahead of the bucket
    flip (device work only, no host→device bytes).  No-op when cold or
    already that big."""
    if store is None or store.cap >= n_cap:
        return store
    store.bufs = _grow_batched(store.bufs, n_cap)
    store.cap = n_cap
    return store
