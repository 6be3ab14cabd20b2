"""Device-mode telemetry: the slab of each segment, backfilled into the obs
stack at the sync boundary.

Counterpart of ``hyperopt_tpu/obs/devtel.py``, with the same functions and
metric names.  Device mode (``fmin(mode="device")``, ``fmin_fleet``) runs
trials as CUDA-graph replays, so between two fetches the hosted obs
layers see nothing.  The slab fills that gap:

* **On the card**, the captured step writes the two per-trial values the
  host cannot recompute, the winning EI score ``ei_best`` and the
  candidate-argmax tie count ``ties`` of its TPE arm, into two
  ``[L, n_cap + 1]`` buffers at the row its trial lands in
  (``device._Segment``): two ``index_copy_`` per replay.  They join the
  segment's one existing device→host copy, so ``device.fetch_syncs`` and
  ``segments`` do not move.
* **On the host**, :func:`slab_host` reduces a segment's columns to the
  JAX package's slab: ``best_loss`` (the run's best-so-far after the
  segment), ``ei_max`` and ``ei_sum`` over its TPE steps, ``tpe_steps``,
  ``nonfinite`` losses, ``argmax_ties``, and the ``best_trajectory``
  reservoir of :data:`RESERVOIR` slots (slot ``t·R//s`` for step ``t`` of
  ``s``; a segment of ``s ≤ R`` steps fills a prefix).  A step is a TPE
  step when the run held ``n_startup`` ok trials before it, the JAX
  package's ``is_tpe``; its startup steps contribute ``-inf`` and 0.
  Under ``fmin_fleet`` every value has a lane axis, ``[L]`` and
  ``[L, R]``, and lane ``j``'s equals its solo run's bit for bit.

:func:`backfill_segment` then lands the slab in

* ``obs.events``: a back-dated ``device_segment`` span and, in solo mode,
  one synthetic ``trial_end`` anchor per trial spread across the
  segment's wall window, every record marked ``synthetic=True``;
* ``obs.metrics``: the ``device.telemetry.*`` gauges, counters and the
  ``segment_ms`` histogram; :func:`bump_labeled` adds the
  ``device.fetch_syncs.<mode>.<stride>`` / ``device.segments.<mode>.
  <stride>`` twins (LRU-bounded labels);
* a time-series store, when one is registered with
  :func:`set_backfill_store` (the service slice plugs its store in here);
* ``obs.costs``: the segment's host wall time as a dispatch row;
* the flight recorder: the latest slab per run, the ``device_telemetry``
  bundle section (:func:`report`);

and :func:`finish_run` publishes the run's health verdict under
``health.verdict.device:<label>``.

Armed (the default; :func:`set_enabled` switches, and device mode reads
:func:`enabled` once per run and keys it into its graph cache) and
disarmed runs land the same trials bit for bit: the stores only read
values the proposal already computes.  Everything here runs on the host
at boundary rate.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from threading import Lock

import numpy as np

from . import bundle as _bundle
from . import costs as _costs
from . import health as _health
from . import metrics as _metrics
from .events import EVENTS

__all__ = ["RESERVOIR", "enabled", "set_enabled", "bump_labeled",
           "slab_host", "backfill_segment", "finish_run",
           "set_backfill_store", "backfill_store", "report"]

#: Slots in the best-so-far trajectory reservoir of each segment.
RESERVOIR = 32

_enabled = True


def enabled() -> bool:
    """Whether device mode carries the slab (default on)."""
    return _enabled


def set_enabled(flag: bool) -> None:
    """Arm (True) or disarm the slab for device-mode runs started after
    the call."""
    global _enabled
    _enabled = bool(flag)


# <mode>.<stride> labels are caller inputs: the live set is LRU-bounded
# exactly like health.verdict.<store>.
_LABELS = _metrics.LabelLru()

# Latest slab per (mode, label) for the flight-bundle provider; bounded
# because labels are caller-controlled.
_LAST_CAP = 8
_LAST: "OrderedDict" = OrderedDict()
_LAST_LOCK = Lock()
_PROVIDER_REGISTERED = False

#: Optional weakref to a store scraped at each sync boundary.
_STORE_REF = None


def set_backfill_store(store) -> None:
    """Register ``store`` (any object with ``scrape(now=<wall seconds>)``,
    or ``None`` to clear) to receive one scrape per sync boundary,
    timestamped at the segment's end.  Held by weakref."""
    global _STORE_REF
    _STORE_REF = None if store is None else weakref.ref(store)


def backfill_store():
    return _STORE_REF() if _STORE_REF is not None else None


def bump_labeled(reg, mode: str, stride: str) -> None:
    """Bump the ``<mode>.<stride>``-labeled twins of the unlabeled
    ``device.fetch_syncs`` / ``device.segments`` counters."""
    label = f"{mode}.{stride}"
    for old in _LABELS.touch(label):
        reg.remove(f"device.fetch_syncs.{old}")
        reg.remove(f"device.segments.{old}")
    reg.counter(f"device.fetch_syncs.{label}").inc()
    reg.counter(f"device.segments.{label}").inc()


def slab_host(losses, ei_best, ties, n_ok0, best0, n_startup) -> dict:
    """One segment's slab from its fetched per-trial columns.

    ``losses`` (the raw losses), ``ei_best`` and ``ties`` are ``[L, s]``
    in trial order; ``n_ok0[L]`` is each lane's count of ok trials and
    ``best0[L]`` its best ok loss (``inf`` for none) before the segment;
    ``n_startup`` is the run's ``n_startup_jobs``.  Returns arrays with a
    leading lane axis: ``best_loss``, ``ei_max``, ``ei_sum`` (float32),
    ``tpe_steps``, ``nonfinite``, ``argmax_ties`` (int64), all ``[L]``,
    and ``best_trajectory`` float32 ``[L, RESERVOIR]``.  Each lane is
    reduced on its own, so a lane's slab does not depend on ``L``."""
    losses = np.asarray(losses, np.float32)
    lanes, s = losses.shape
    ei_best = np.asarray(ei_best, np.float32).reshape(lanes, s)
    ties = np.asarray(ties, np.int64).reshape(lanes, s)
    n_ok0 = np.asarray(n_ok0, np.int64).reshape(lanes)
    best0 = np.asarray(best0, np.float32).reshape(lanes)
    if s <= RESERVOIR:
        idx = None
    else:
        # Slot t·R//s keeps the last step landing in it: slot r's winner
        # is step ((r + 1)·s - 1) // R.
        idx = ((np.arange(RESERVOIR) + 1) * s - 1) // RESERVOIR
    out = {k: [] for k in ("best_loss", "ei_max", "ei_sum", "tpe_steps",
                           "nonfinite", "argmax_ties", "best_trajectory")}
    for j in range(lanes):
        lok = np.isfinite(losses[j])
        n_ok = n_ok0[j] + np.cumsum(lok) - lok
        tpe = n_ok >= n_startup
        traj = np.minimum(np.minimum.accumulate(
            np.where(lok, losses[j], np.float32(np.inf))), best0[j])
        if idx is None:
            bsf = np.full(RESERVOIR, np.inf, np.float32)
            bsf[:s] = traj
        else:
            bsf = traj[idx]
        ei = np.where(tpe, ei_best[j], np.float32(-np.inf))
        out["best_loss"].append(traj[-1])
        out["ei_max"].append(ei.max())
        out["ei_sum"].append(
            np.float32(ei_best[j][tpe].sum(dtype=np.float64)))
        out["tpe_steps"].append(int(tpe.sum()))
        out["nonfinite"].append(int((~lok).sum()))
        out["argmax_ties"].append(int(ties[j][tpe].sum()))
        out["best_trajectory"].append(bsf)
    ints = ("tpe_steps", "nonfinite", "argmax_ties")
    return {k: np.asarray(v, np.int64 if k in ints else np.float32)
            for k, v in out.items()}


def _emit_backdated(etype, mono, **fields):
    """Emit one event with an explicit back-dated timestamp pair derived
    from the log's own wall/mono anchor; every synthesized record carries
    ``synthetic=True``."""
    wall = EVENTS._wall0 + (mono - EVENTS._mono0)
    return EVENTS.emit(etype, t_mono=mono, t_wall=wall, synthetic=True,
                       **fields)


def _aggregate(h: dict) -> dict:
    """Collapse a lane-stacked host slab to run-level scalars: best = min
    over lanes, ei_max = max, counts summed, ei mean over all TPE steps
    pooled across lanes."""
    n_tpe = int(h["tpe_steps"].sum())
    ei_sum = float(np.asarray(h["ei_sum"]).sum(dtype=np.float64))
    return {
        "best_loss": float(h["best_loss"].min()),
        "ei_max": float(h["ei_max"].max()),
        "ei_mean": (ei_sum / n_tpe) if n_tpe else None,
        "tpe_steps": n_tpe,
        "nonfinite": int(h["nonfinite"].sum()),
        "argmax_ties": int(h["argmax_ties"].sum()),
    }


def backfill_segment(reg, *, mode: str, stride: str, slab_h: dict,
                     n_trials: int, n_lanes: int, t0_mono: float,
                     t1_mono: float, seg_index: int, cost_key=None,
                     tids=None, label=None) -> dict:
    """Backfill ONE segment's slab into events / metrics / costs / the
    store.  ``t0_mono``/``t1_mono`` bracket the segment's host wall window
    (first replay enqueued → fetch landed); ``tids`` (solo mode) are the
    landed trial ids for the synthetic per-trial anchors.  Returns the
    aggregated slab summary (also kept for bundles)."""
    agg = _aggregate(slab_h)
    dur = max(t1_mono - t0_mono, 0.0)
    total = n_trials * max(n_lanes, 1)

    if np.isfinite(agg["best_loss"]):
        reg.gauge("device.telemetry.best_loss").set(agg["best_loss"])
    if np.isfinite(agg["ei_max"]):
        reg.gauge("device.telemetry.ei_max").set(agg["ei_max"])
    if agg["ei_mean"] is not None and np.isfinite(agg["ei_mean"]):
        reg.gauge("device.telemetry.ei_mean").set(agg["ei_mean"])
    if agg["nonfinite"]:
        reg.counter("device.telemetry.nonfinite").inc(agg["nonfinite"])
    if agg["argmax_ties"]:
        reg.counter("device.telemetry.argmax_ties").inc(
            agg["argmax_ties"])
    reg.histogram("device.telemetry.segment_ms").observe(dur * 1e3)
    if dur > 0:
        reg.gauge("device.telemetry.trials_per_sec").set(total / dur)

    if EVENTS.enabled:
        sid = next(EVENTS._span_ids)
        _emit_backdated("span_begin", t0_mono, name="device_segment",
                        span=sid, parent=None, mode=mode, stride=stride,
                        seg=seg_index, n_trials=n_trials,
                        n_lanes=n_lanes)
        if tids is not None and n_trials:
            # Spread uniformly across the measured window: the host knows
            # only the boundary, not per-trial device times; readers
            # filter on the "synthetic" mark.
            step = dur / n_trials
            for k, tid in enumerate(tids):
                _emit_backdated("trial_end", t0_mono + (k + 0.5) * step,
                                name="device_trial", trial=int(tid),
                                span=sid, mode=mode, seg=seg_index)
        _emit_backdated("span_end", t1_mono, name="device_segment",
                        span=sid, parent=None)

    if cost_key is not None:
        _costs.observe_dispatch(cost_key, dur * 1e3)

    store = backfill_store()
    if store is not None:
        store.scrape(now=EVENTS._wall0 + (t1_mono - EVENTS._mono0))

    global _PROVIDER_REGISTERED
    summary = dict(agg)
    summary.update({
        "mode": mode, "stride": stride, "seg": seg_index,
        "n_trials": n_trials, "n_lanes": n_lanes,
        "segment_s": dur,
        "best_trajectory": np.round(
            np.ravel(slab_h["best_trajectory"])[:RESERVOIR].astype(
                np.float64), 6).tolist(),
    })
    with _LAST_LOCK:
        key = (mode, label or mode)
        _LAST.pop(key, None)
        _LAST[key] = summary
        while len(_LAST) > _LAST_CAP:
            _LAST.popitem(last=False)
        if not _PROVIDER_REGISTERED:
            _bundle.register_provider("device_telemetry", report)
            _PROVIDER_REGISTERED = True
    return summary


def finish_run(reg, trials, *, mode: str, label=None) -> dict | None:
    """Run-end health pass over the landed docs: one ``health.assess`` and
    its publication under ``device:<label>``."""
    docs = list(trials.trials)
    if not docs:
        return None
    rep = _health.assess(docs)
    _health.publish(f"device:{label or mode}", rep, reg)
    return rep


def report() -> dict:
    """Flight-bundle section: the latest slab summary per live run."""
    with _LAST_LOCK:
        runs = [dict(v) for v in _LAST.values()]
    return {"enabled": enabled(), "reservoir": RESERVOIR, "runs": runs}
