"""Experiment inspection CLI of the PyTorch port (console script
``hyperopt-tpu-torch-show``).

Counterpart of ``hyperopt_tpu/show.py``, every verb on the port's
modules: summarize a live experiment's state from its store, a trace
directory, a live server's metrics, a WAL directory, a flight bundle or
the port's analyzer report.  One difference: ``live`` takes the server
token from ``--token`` only, never from the environment.

Usage::

    hyperopt-tpu-torch-show --root /shared/exp --exp-key e1
    hyperopt-tpu-torch-show --pickle trials.pkl [--plot history.png]
    hyperopt-tpu-torch-show trace /tmp/trace      # per-phase span table
    hyperopt-tpu-torch-show trace --merge /tmp/driver /tmp/worker0 \
        -o merged_trace.json                      # fleet Perfetto trace
    hyperopt-tpu-torch-show live http://host:8999 [--token ...] [--once]
    hyperopt-tpu-torch-show wal /srv/wal-dir [--json]   # WAL summary
    hyperopt-tpu-torch-show bundle /tmp/bundle-123-000-slo  # postmortem
    hyperopt-tpu-torch-show lint [--root .]       # the port's analyzers

(``python -m hyperopt_tpu_torch.show`` is the same.)
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from collections import Counter, defaultdict

from .base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Trials,
)
from .exceptions import AllTrialsFailed

_STATE_NAMES = {JOB_STATE_NEW: "new", JOB_STATE_RUNNING: "running",
                JOB_STATE_DONE: "done", JOB_STATE_ERROR: "error",
                JOB_STATE_CANCEL: "cancel"}


def summarize(trials: Trials, out=None) -> None:
    # Resolve the stream at CALL time: an import-time `out=sys.stdout`
    # default would capture whatever stdout object existed when this module
    # was first imported (possibly a since-closed redirection).
    out = out if out is not None else sys.stdout
    states = Counter(t["state"] for t in trials)
    print(f"trials: {len(trials)}", file=out)
    for s, name in _STATE_NAMES.items():
        if states.get(s):
            print(f"  {name:8s} {states[s]}", file=out)
    try:
        best = trials.best_trial
        print(f"best loss: {best['result']['loss']:.6g} "
              f"(tid {best['tid']})", file=out)
        point = {k: v[0] for k, v in best["misc"]["vals"].items() if v}
        for k in sorted(point):
            print(f"  {k} = {point[k]}", file=out)
    except AllTrialsFailed:
        print("best loss: (no successful trials yet)", file=out)
    owners = Counter(t.get("owner") for t in trials if t.get("owner"))
    if owners:
        print("workers:", file=out)
        for owner, n in owners.most_common():
            print(f"  {owner}: {n}", file=out)
    try:
        n_att = len(trials.attachments)
    except Exception:
        n_att = 0
    if n_att:
        print(f"attachments: {n_att}", file=out)


def summarize_trace(trace_dir: str, out=None) -> None:
    """Render a trace directory (``fmin(..., trace_dir=...)``) as a
    per-phase summary table — the table the bench scripts used to
    hand-roll.  Prefers the aggregated ``loop_trace.json``; falls back to
    re-deriving span totals from ``loop_events.jsonl``."""
    out = out if out is not None else sys.stdout
    summary_path = os.path.join(trace_dir, "loop_trace.json")
    events_path = os.path.join(trace_dir, "loop_events.jsonl")
    wall = None
    phases = {}
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            doc = json.load(f)
        wall = doc.pop("_wall", None)
        phases = {k: v for k, v in doc.items() if isinstance(v, dict)
                  and "total_s" in v}
    elif os.path.exists(events_path):
        begins, totals, counts = {}, defaultdict(float), defaultdict(int)
        with open(events_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["type"] == "span_begin":
                    begins[rec.get("span")] = rec
                elif rec["type"] == "span_end":
                    b = begins.pop(rec.get("span"), None)
                    if b is not None:
                        totals[b["name"]] += rec["t_mono"] - b["t_mono"]
                        counts[b["name"]] += 1
        phases = {n: {"total_s": t, "count": counts[n],
                      "mean_ms": 1e3 * t / max(counts[n], 1)}
                  for n, t in totals.items()}
    else:
        print(f"no loop_trace.json or loop_events.jsonl in {trace_dir}",
              file=out)
        return
    wall_s = wall["wall_s"] if wall else sum(
        v["total_s"] for v in phases.values()) or 1.0
    print(f"{'phase':<14s} {'total_s':>10s} {'count':>7s} "
          f"{'mean_ms':>9s} {'% wall':>7s}", file=out)
    for name, rec in sorted(phases.items(),
                            key=lambda kv: -kv[1]["total_s"]):
        print(f"{name:<14s} {rec['total_s']:>10.4f} {rec['count']:>7d} "
              f"{rec['mean_ms']:>9.3f} "
              f"{100.0 * rec['total_s'] / max(wall_s, 1e-12):>6.1f}%",
              file=out)
    if wall:
        print(f"wall {wall['wall_s']:.4f}s, attributed "
              f"{wall['attributed_s']:.4f}s "
              f"({100.0 * wall['coverage']:.1f}% coverage)", file=out)
    if os.path.exists(events_path):
        n_events, n_dropped = 0, 0
        with open(events_path) as fh:
            for line in fh:
                n_events += 1
                if n_events == 1:
                    try:
                        head = json.loads(line)
                    except ValueError:
                        head = {}
                    if isinstance(head, dict) and head.get("type") == "meta":
                        n_dropped = int(head.get("n_dropped") or 0)
        dropped = (f" ({n_dropped} displaced at the ring)"
                   if n_dropped else "")
        print(f"events: {n_events} in loop_events.jsonl{dropped}", file=out)
    chrome = os.path.join(trace_dir, "chrome_trace.json")
    if os.path.exists(chrome):
        print(f"chrome trace: {chrome} (load in Perfetto / "
              f"chrome://tracing)", file=out)


# -- cross-process trace stitching ------------------------------------------

def _load_events_file(path):
    """Read one ``loop_events.jsonl``: returns ``(meta, events)``.

    The ``{"type": "meta"}`` header (process identity + wall/mono clock
    anchor + heartbeat-estimated ``skew_s``) is separated from the event
    records; files written before the header existed yield ``{}``.
    """
    meta, events = {}, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "meta":
                meta = rec
            else:
                events.append(rec)
    return meta, events


def merge_traces(dirs, out_path=None, out=None) -> dict:
    """Stitch several processes' ``loop_events.jsonl`` into ONE Chrome
    trace: one ``pid`` lane per source process, clock-normalized, with
    per-trial flow arrows crossing lane boundaries.

    Clock normalization: every record's display timestamp is recomputed
    from its monotonic clock via the file's own meta anchor,
    ``wall0 + (t_mono - mono0) - skew_s``.  ``skew_s`` is the process's
    wall offset relative to the netstore server (estimated from heartbeat
    replies, 0 for the server itself), so all lanes land in the *server's*
    clock frame even when the machines' wall clocks disagree.

    Flow arrows: any trial whose events appear in ≥2 lanes gets a Chrome
    flow (``ph: s/t/f`` sharing ``id``) threaded through its anchors —
    suggest→claim→evaluate→record across process boundaries renders as
    arrows in Perfetto.
    """
    out = out if out is not None else sys.stdout
    sources = []
    for d in dirs:
        path = (d if d.endswith(".jsonl")
                else os.path.join(d, "loop_events.jsonl"))
        meta, events = _load_events_file(path)
        if meta.get("wall0") is None or meta.get("mono0") is None:
            # A file without the {wall0, mono0} meta anchor can't be
            # clock-normalized into the shared frame: its t_wall would
            # land the lane wherever that process's clock happened to
            # be, silently corrupting cross-lane ordering.  Skip it
            # before lane numbering so kept lanes stay contiguous.
            print(f"warning: {path}: missing {{wall0, mono0}} meta "
                  "anchor; skipping (cannot clock-normalize)", file=out)
            continue
        sources.append((path, meta, events))

    from .obs.events import events_to_chrome

    trace_events, all_anchors = [], []
    for i, (path, meta, events) in enumerate(sources):
        pid = i + 1  # one Perfetto lane per source process
        wall0, mono0 = meta["wall0"], meta["mono0"]
        skew = meta.get("skew_s", 0.0) or 0.0

        def ts_fn(rec, _w=wall0, _m=mono0, _s=skew):
            return _w + (rec["t_mono"] - _m) - _s
        evs, anchors = events_to_chrome(events, pid=pid, ts_fn=ts_fn)
        label = (meta.get("worker_id") or meta.get("role")
                 or os.path.basename(os.path.dirname(os.path.abspath(path)))
                 or f"proc{i}")
        if meta.get("pid") is not None:
            label = f"{label} (os pid {meta['pid']})"
        trace_events.append({"name": "process_name", "ph": "M", "pid": pid,
                             "tid": 0, "args": {"name": label}})
        trace_events.extend(evs)
        all_anchors.extend(anchors)

    # Per-trial flow arrows.  Anchors are deduped to one per (lane pid,
    # event type) — the earliest — so a trial retried in one process
    # doesn't spray N arrows; only trials seen in ≥2 lanes get a flow.
    by_trial = defaultdict(dict)
    for ts_us, pid, lane, trial, etype in all_anchors:
        key = (pid, etype)
        cur = by_trial[trial].get(key)
        if cur is None or ts_us < cur[0]:
            by_trial[trial][key] = (ts_us, pid, lane, etype)
    flows, n_flows = [], 0
    for trial in sorted(by_trial, key=str):
        pts = sorted(by_trial[trial].values())
        if len({p[1] for p in pts}) < 2:
            continue  # flow arrows only for cross-process trials
        n_flows += 1
        for j, (ts_us, pid, lane, etype) in enumerate(pts):
            ev = {"name": f"trial {trial}", "cat": "trial_flow",
                  "ph": "s" if j == 0 else
                        ("f" if j == len(pts) - 1 else "t"),
                  "id": str(trial), "ts": ts_us, "pid": pid, "tid": lane}
            if ev["ph"] == "f":
                ev["bp"] = "e"  # bind the arrowhead to the enclosing slice
            flows.append(ev)

    doc = {
        "traceEvents": trace_events + flows,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_from": [p for p, _, _ in sources],
            "n_lanes": len(sources),
            "n_trial_flows": n_flows,
        },
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(doc, fh)
        print(f"wrote {out_path}", file=out)
    print(f"merged {len(sources)} lane(s), "
          f"{sum(len(e) for _, _, e in sources)} events, "
          f"{n_flows} cross-process trial flow(s)", file=out)
    return doc


# -- live fleet dashboard ---------------------------------------------------

def fetch_metrics(url: str, token=None, timeout: float = 5.0) -> dict:
    """GET ``<url>/metrics`` from a netstore server (token-gated)."""
    import urllib.request

    base = url.rstrip("/")
    if not base.endswith("/metrics"):
        base += "/metrics"
    req = urllib.request.Request(base)
    if token:
        req.add_header("X-Netstore-Token", token)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _hist_row(name, h):
    """One per-verb table row from a histogram summary dict (seconds)."""
    if not h or not h.get("count"):
        return None
    ms = lambda v: f"{1e3 * v:8.2f}" if v is not None else "       -"  # noqa: E731
    return (f"  {name:<28s} {int(h['count']):>7d} {ms(h.get('p50'))} "
            f"{ms(h.get('p95'))} {ms(h.get('p99'))}")


def render_live(snap: dict, out=None, prev=None) -> dict:
    """Render one dashboard frame from a ``GET /metrics`` payload.

    ``prev`` is the previous ``(t, counters)`` sample used to derive
    rates (trials/s); returns this frame's sample for the next call.
    """
    out = out if out is not None else sys.stdout
    now = time.monotonic()
    fleet = snap.get("fleet", {})
    merged = fleet.get("merged", {})
    counters = dict(snap.get("counters", {}))
    for k, v in merged.get("counters", {}).items():
        counters[k] = max(counters.get(k, 0), v)  # merged already sums local
    gauges = snap.get("gauges", {})
    m_gauges = merged.get("gauges", {})

    done = counters.get("fmin.trials.done", 0) + counters.get(
        "worker.trials", 0)
    rate = ""
    if prev is not None:
        dt = now - prev[0]
        if dt > 0:
            d_done = done - prev[1]
            rate = f"   {d_done / dt:6.2f} trials/s"
    print(f"fleet: {fleet.get('n_workers', 0)} worker(s)   "
          f"trials done {done}{rate}", file=out)

    # SHARDS: the fleet router's per-shard panel (snap["router"], present
    # only when the URL polled is a service/router.py front).  Latency
    # tails come from the router's own router.shard.<sid>.s forward
    # histograms; a shard that did not answer the metrics pull renders
    # as DOWN with the error instead of failing the frame.
    router = snap.get("router")
    if router is not None:
        shards = router.get("shards", {})
        print(f"router: {router.get('n_shards', len(shards))} shard(s)   "
              f"map v{router.get('version', '?')}   forwarded "
              f"{int(counters.get('router.forwarded', 0))}   failovers "
              f"{int(counters.get('router.failovers', 0))}   rebalances "
              f"{int(counters.get('router.rebalances', 0))}", file=out)
        if shards:
            r_hists = snap.get("histograms", {})
            pct = lambda h, q: (f"{1e3 * h[q]:8.2f}"  # noqa: E731
                                if h and h.get(q) is not None
                                else f"{'-':>8s}")
            print(f"  {'shard':<12s} {'status':<6s} {'workers':>7s} "
                  f"{'calls':>8s} {'fwd':>6s} {'p50ms':>8s} {'p95ms':>8s} "
                  f"{'p99ms':>8s}", file=out)
            for sid in sorted(shards):
                info = shards[sid]
                h = r_hists.get(f"router.shard.{sid}.s") or {}
                fwd = int(h.get("count", 0))
                if info.get("ok"):
                    print(f"  {sid:<12s} {'ok':<6s} "
                          f"{int(info.get('n_workers', 0)):>7d} "
                          f"{int(info.get('verb_calls', 0)):>8d} "
                          f"{fwd:>6d} {pct(h, 'p50')} {pct(h, 'p95')} "
                          f"{pct(h, 'p99')}", file=out)
                else:
                    print(f"  {sid:<12s} {'DOWN':<6s} {'-':>7s} {'-':>8s} "
                          f"{fwd:>6d} {pct(h, 'p50')} {pct(h, 'p95')} "
                          f"{pct(h, 'p99')}  "
                          f"{info.get('error', '?')}", file=out)
    # AUTOSCALE: the control plane's decision-log tail (snap["autoscale"],
    # present when an Autoscaler is attached to the polled router).  Each
    # row is one WAL-durable decision — the runbook's first stop when a
    # topology change needs explaining.
    auto = snap.get("autoscale")
    if auto is not None:
        if auto.get("error"):
            print(f"autoscale: UNAVAILABLE {auto['error']}", file=out)
        else:
            shed = auto.get("shed_level", 0.0)
            print(f"autoscale: {'running' if auto.get('running') else 'idle'}"
                  f"   shed {shed:.0%}   calm {auto.get('calm', 0)}/"
                  f"{auto.get('calm_ticks', '?')}   bounds "
                  f"[{auto.get('min_shards', '?')}, "
                  f"{auto.get('max_shards', '?')}] shards", file=out)
            decisions = auto.get("decisions") or []
            for d in decisions[-6:]:
                when = time.strftime("%H:%M:%S",
                                     time.localtime(d.get("t", 0)))
                ok = ("ok" if d.get("ok")
                      else f"FAILED {d.get('error', '')}")
                print(f"  {when} {d.get('action', '?'):<11s} "
                      f"burn {d.get('burn', 0):>6.2f}  "
                      f"shards {d.get('shards', '?'):>2}  {ok}  "
                      f"{d.get('reason', '')}", file=out)
    occ = gauges.get("pipeline.occupancy", m_gauges.get("pipeline.occupancy"))
    backlog = gauges.get("pipeline.eval_backlog",
                         m_gauges.get("pipeline.eval_backlog"))
    if occ is not None or backlog is not None:
        print(f"pipeline: occupancy {occ if occ is not None else '-'}   "
              f"eval backlog {backlog if backlog is not None else '-'}",
              file=out)
    # Cohort occupancy of the fleet dispatch path: how full the last
    # vmap-batched dispatch ran (real lanes / pow2 tier) and the padding
    # it paid, plus aggregate dispatch/suggestion volume.
    disp = counters.get("fleet.dispatches", 0)
    if disp:
        size = gauges.get("fleet.cohort_size_last",
                          m_gauges.get("fleet.cohort_size_last", 0))
        tier = gauges.get("fleet.cohort_tier_last",
                          m_gauges.get("fleet.cohort_tier_last", 0))
        waste = gauges.get("fleet.padding_waste",
                           m_gauges.get("fleet.padding_waste", 0.0))
        print(f"cohorts: last {int(size)}/{int(tier)} lanes   "
              f"padding {waste:.0%}   dispatches {int(disp)}   "
              f"suggestions {int(counters.get('fleet.suggestions', 0))}",
              file=out)
    # DEVICE: the device-resident loop's sync-boundary view — segment /
    # fetch totals split by (mode, stride) label, plus the in-carry
    # telemetry slab's latest levels (obs.devtel backfill).
    segs = counters.get("device.segments", 0)
    if segs:
        print(f"device:  segments {int(segs)}   fetches "
              f"{int(counters.get('device.fetch_syncs', 0))}   landed "
              f"{int(counters.get('device.trials_landed', 0))}", file=out)
        labeled = {}
        for k, v in counters.items():
            if k.startswith("device.segments."):
                labeled.setdefault(k[len("device.segments."):],
                                   [0, 0])[0] += v
            elif k.startswith("device.fetch_syncs."):
                labeled.setdefault(k[len("device.fetch_syncs."):],
                                   [0, 0])[1] += v
        if labeled:
            print(f"  {'mode.stride':<16s} {'segments':>9s} "
                  f"{'fetches':>8s}", file=out)
            for lab in sorted(labeled):
                sN, fN = labeled[lab]
                print(f"  {lab:<16s} {int(sN):>9d} {int(fN):>8d}",
                      file=out)
        tel_best = gauges.get("device.telemetry.best_loss",
                              m_gauges.get("device.telemetry.best_loss"))
        if tel_best is not None:
            ei_mx = gauges.get("device.telemetry.ei_max",
                               m_gauges.get("device.telemetry.ei_max"))
            ei_mn = gauges.get("device.telemetry.ei_mean",
                               m_gauges.get("device.telemetry.ei_mean"))
            tps = gauges.get(
                "device.telemetry.trials_per_sec",
                m_gauges.get("device.telemetry.trials_per_sec"))
            fmt = lambda v: "-" if v is None else f"{v:.4g}"  # noqa: E731
            print(f"  slab: best {fmt(tel_best)}   ei max {fmt(ei_mx)} "
                  f"mean {fmt(ei_mn)}   {fmt(tps)} trials/s   nonfinite "
                  f"{int(counters.get('device.telemetry.nonfinite', 0))}"
                  f"   ties "
                  f"{int(counters.get('device.telemetry.argmax_ties', 0))}",
                  file=out)
    faults = counters.get("faults.injected", 0)
    requeued = counters.get("store.requeued", 0)
    fenced = (counters.get("store.write.fenced", 0)
              + counters.get("store.heartbeat.fenced", 0))
    print(f"faults injected {faults}   requeued {requeued}   "
          f"fenced {fenced}", file=out)
    pool_hits = counters.get("rpc.pool.hits", 0)
    pool_misses = counters.get("rpc.pool.misses", 0)
    if pool_hits or pool_misses:
        total = pool_hits + pool_misses
        print(f"pool: {int(pool_hits)}/{int(total)} reused "
              f"({pool_hits / total:.0%})   stale reconnects "
              f"{int(counters.get('rpc.pool.stale_reconnects', 0))}   "
              f"evicted {int(counters.get('rpc.pool.evicted', 0))}",
              file=out)
    parked = counters.get("store.longpoll.parked", 0)
    if parked:
        print(f"longpoll: parked {int(parked)}   woken "
              f"{int(counters.get('store.longpoll.woken', 0))}   timeouts "
              f"{int(counters.get('store.longpoll.timeouts', 0))}",
              file=out)

    # Per-verb server-side latency tails (+ merged client-side RPC time).
    hists = dict(snap.get("histograms", {}))
    for k, v in merged.get("histograms", {}).items():
        hists.setdefault(k, v)
    rows = []
    for name in sorted(hists):
        if name.startswith("netstore.verb.") and name.endswith(".s"):
            row = _hist_row(name[len("netstore.verb."):], hists[name])
            if row:
                rows.append(row)
    rpc = _hist_row("client.rpc (merged)", hists.get("netstore.client.rpc.s"))
    if rpc:
        rows.append(rpc)
    if rows:
        print(f"  {'verb':<28s} {'count':>7s} {'p50ms':>8s} "
              f"{'p95ms':>8s} {'p99ms':>8s}", file=out)
        for row in rows:
            print(row, file=out)

    # Per-tenant lane of the suggestion service (netstore.tenant.<t>.*):
    # verb volume, quota refusals and held claims, labeled by tenant.
    tenants = {}
    for k, v in counters.items():
        if not k.startswith("netstore.tenant."):
            continue
        rest = k[len("netstore.tenant."):]
        tname, _, metric = rest.partition(".")
        rec = tenants.setdefault(tname, {"calls": 0, "rate_rej": 0,
                                         "claims_rej": 0})
        if metric.startswith("verb.") and metric.endswith(".calls"):
            rec["calls"] += v
        elif metric == "quota.rate_rejected":
            rec["rate_rej"] += v
        elif metric == "quota.claims_rejected":
            rec["claims_rej"] += v
    if tenants:
        print(f"  {'tenant':<20s} {'calls':>8s} {'claims':>7s} "
              f"{'rate.rej':>9s} {'claim.rej':>10s}", file=out)
        for tname in sorted(tenants):
            rec = tenants[tname]
            held = gauges.get(f"netstore.tenant.{tname}.claims_held",
                              m_gauges.get(
                                  f"netstore.tenant.{tname}.claims_held"))
            print(f"  {tname:<20s} {int(rec['calls']):>8d} "
                  f"{held if held is not None else '-':>7} "
                  f"{int(rec['rate_rej']):>9d} {int(rec['claims_rej']):>10d}",
                  file=out)

    workers = fleet.get("workers", {})
    if workers:
        print("workers:", file=out)
        for wid in sorted(workers):
            w = workers[wid]
            age = w.get("age_s", 0.0)
            wc = w.get("counters", {})
            wg = w.get("gauges", {})
            stale = "  STALE" if age > 30.0 else ""
            print(f"  {wid:<28s} age {age:6.1f}s  trials "
                  f"{int(wc.get('worker.trials', 0)):>5d}  fails "
                  f"{wg.get('worker.consecutive_failures', 0)}{stale}",
                  file=out)

    # HEALTH: per-(tenant, exp_key) optimizer-health verdicts from the
    # server's last assessment pass (snap["health"], the `health` verb's
    # cache) — stagnation / EI-collapse surface here before loss curves
    # make them obvious.
    health = snap.get("health") or {}
    if health:
        print(f"health:  {'store':<26s} {'verdict':<12s} {'done':>5s} "
              f"{'best':>12s}  flags", file=out)
        for label in sorted(health):
            rep = health[label] or {}
            checks = rep.get("checks", {})
            flags = ",".join(k for k in ("stagnating", "ei_collapse",
                                         "dup_high", "split_degenerate")
                             if checks.get(k)) or "-"
            best = rep.get("best_loss")
            best_s = "-" if best is None else f"{best:.5g}"
            print(f"         {label:<26s} {rep.get('verdict', '?'):<12s} "
                  f"{int(rep.get('n_done', 0)):>5d} {best_s:>12s}  {flags}",
                  file=out)

    # ALERTS: SLO burn-rate state from the server's monitor
    # (snap["alerts"]); firing specs are the ones eating error budget
    # faster than it accrues in BOTH windows.
    alerts = snap.get("alerts") or []
    if alerts:
        fmt_b = lambda b: "    -" if b is None else f"{b:5.2f}"  # noqa: E731
        print(f"alerts:  {'slo':<20s} {'state':<8s} {'burn.fast':>9s} "
              f"{'burn.slow':>9s} {'value':>10s} {'target':>10s}", file=out)
        for st in alerts:
            state = "FIRING" if st.get("firing") else "ok"
            val = st.get("value")
            val_s = "-" if val is None else f"{val:.4g}"
            print(f"         {st['name']:<20s} {state:<8s} "
                  f"{fmt_b(st.get('burn_fast')):>9s} "
                  f"{fmt_b(st.get('burn_slow')):>9s} "
                  f"{val_s:>10s} {st.get('target'):>10}", file=out)

    # COST: the per-kernel cost ledger (snap["costs"], populated when the
    # serving process armed it with ``obs.costs.arm()``) — build wall time
    # and the ledger's flops/bytes per program, joined with live dispatch
    # ms.
    _render_cost_panel(snap.get("costs"), counters, out)
    return (now, done)


def _cost_ledger_rows(costs: dict):
    """Format a cost ledger's ``entries`` into (header, rows) table lines."""
    header = (f"  {'kernel':<7s} {'n_cap':>6s} {'P':>4s} {'m':>5s} "
              f"{'compile_s':>9s} {'Mflops':>8s} {'MiB':>8s} "
              f"{'disp':>6s} {'ms/sugg':>8s}")
    dash = lambda v, w: f"{v:>{w}}" if v is not None else f"{'-':>{w}}"  # noqa: E731
    rows = []
    for e in costs.get("entries") or []:
        cs = e.get("compile_s")
        fl = e.get("flops")
        ba = e.get("bytes_accessed")
        mps = e.get("ms_per_suggestion")
        rows.append(
            f"  {e.get('kernel', '?'):<7s} {dash(e.get('n_cap'), 6)} "
            f"{dash(e.get('P'), 4)} {dash(e.get('m'), 5)} "
            f"{dash(None if cs is None else f'{cs:.3f}', 9)} "
            f"{dash(None if fl is None else f'{fl / 1e6:.2f}', 8)} "
            f"{dash(None if ba is None else f'{ba / 2**20:.2f}', 8)} "
            f"{int(e.get('dispatches', 0)):>6d} "
            f"{dash(None if mps is None else f'{mps:.3f}', 8)}")
    return header, rows


def _render_cost_panel(costs, counters, out) -> None:
    """The ``cost:`` dashboard panel — shared by ``live`` and ``bundle``."""
    costs = costs or {}
    header, rows = _cost_ledger_rows(costs)
    if rows:
        kc = costs.get("kernel_cache", {})
        print(f"cost:    {len(rows)} ledger entr(ies)   kernel-cache "
              f"{int(kc.get('requests', 0))} req / "
              f"{int(kc.get('misses', 0))} miss", file=out)
        print(header, file=out)
        for row in rows:
            print(row, file=out)
        live_ms = costs.get("live_ms") or {}
        for name in sorted(live_ms):
            h = live_ms[name]
            mean = h.get("mean")
            p95 = h.get("p95")
            print(f"  {name:<28s} {int(h.get('count', 0)):>7d} calls  "
                  f"mean {mean if mean is None else f'{mean:.2f}'}ms  "
                  f"p95 {p95 if p95 is None else f'{p95:.2f}'}ms", file=out)
    elif counters.get("cost.compiles"):
        # The recorder is armed somewhere in the fleet but this process
        # holds no ledger rows (compiles happened in another process).
        print(f"cost:    {int(counters['cost.compiles'])} compile(s) "
              f"recorded elsewhere in the fleet (no local ledger rows)",
              file=out)


def live(url: str, token=None, interval: float = 2.0, once: bool = False,
         out=None) -> int:
    """Poll ``GET /metrics`` into a terminal dashboard (ctrl-C to stop)."""
    out = out if out is not None else sys.stdout
    prev = None
    while True:
        try:
            snap = fetch_metrics(url, token=token)
        except Exception as e:
            print(f"fetch failed: {type(e).__name__}: {e}", file=out)
            if once:
                return 1
            time.sleep(interval)
            continue
        if not once and out is sys.stdout and sys.stdout.isatty():
            print("\x1b[2J\x1b[H", end="", file=out)
        print(f"-- {url} --", file=out)
        prev = render_live(snap, out=out, prev=prev)
        if once:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


# -- WAL inspection ---------------------------------------------------------

def show_wal(wal_dir: str, as_json: bool = False, out=None) -> int:
    """Offline summary of a :class:`~.service.server.ServiceServer` WAL
    directory: snapshot coverage, unsnapshotted tail records per verb and
    per (tenant, exp_key) store, torn-tail count."""
    out = out if out is not None else sys.stdout
    from .service.wal import inspect as wal_inspect

    info = wal_inspect(wal_dir)
    if as_json:
        json.dump(info, out, indent=2, sort_keys=True)
        print(file=out)
        return 0
    print(f"wal dir: {info['root']}", file=out)
    snap = info["snapshot"]
    if snap is None:
        print("snapshot: (none)", file=out)
    else:
        age = ""
        if snap.get("t_wall"):
            age = f", written {time.time() - snap['t_wall']:.0f}s ago"
        print(f"snapshot: seq {snap['seq']}, {snap['stores']} store(s), "
              f"{snap['idem_entries']} idem entr(ies), "
              f"{snap['bytes']} bytes{age}", file=out)
    rng = info["seq_range"]
    print(f"tail: {info['records']} record(s)"
          + (f" (seq {rng[0]}..{rng[1]})" if rng else "")
          + f", {info['wal_bytes']} bytes", file=out)
    if info["per_verb"]:
        print("  per verb:", file=out)
        for verb, n in sorted(info["per_verb"].items(),
                              key=lambda kv: -kv[1]):
            print(f"    {verb:<16s} {n}", file=out)
    if info["per_store"]:
        print("  per store (tenant/exp_key):", file=out)
        for key, n in sorted(info["per_store"].items(),
                             key=lambda kv: -kv[1]):
            print(f"    {key:<24s} {n}", file=out)
    if info["torn_tail"]:
        print(f"torn tail: {info['torn_tail']} line(s) dropped "
              "(crash mid-append; the verb was never acked)", file=out)
    return 0


# -- flight-recorder bundles -------------------------------------------------

def show_bundle(bundle_dir: str, out=None) -> int:
    """Render a flight-recorder postmortem bundle directory
    (:mod:`hyperopt_tpu_torch.obs.bundle`): manifest, event-ring coverage,
    section inventory, SLO/health verdicts, WAL anchor and the
    per-kernel cost ledger."""
    out = out if out is not None else sys.stdout
    from .obs import bundle as _bundle

    try:
        payload = _bundle.read_bundle(bundle_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=out)
        return 1
    man = payload.get("manifest") or {}
    print(f"bundle: {bundle_dir}", file=out)
    print(f"  schema {man.get('schema')}   reason {man.get('reason')!r}   "
          f"pid {man.get('pid')}   host {man.get('host')}", file=out)
    if man.get("trace_id"):
        print(f"  trace_id {man['trace_id']}  (splice into a fleet trace: "
              f"`show trace --merge {bundle_dir} <other dirs...>`)", file=out)
    print(f"  events: {man.get('n_events', 0)} captured, "
          f"{man.get('n_emitted', 0)} emitted, "
          f"{man.get('n_dropped', 0)} displaced at the ring", file=out)
    if man.get("extra"):
        print(f"  extra: {man['extra']}", file=out)
    print(f"  sections: {', '.join(man.get('sections') or [])}", file=out)

    # Event-type census of the captured ring (meta header excluded).
    types = Counter(rec.get("type") for rec in payload.get("events") or []
                    if rec.get("type") not in (None, "meta"))
    if types:
        census = "  ".join(f"{t}:{n}" for t, n in types.most_common(8))
        print(f"  ring: {census}", file=out)

    slo = payload.get("slo")
    if isinstance(slo, list) and slo:
        firing = [st for st in slo if isinstance(st, dict)
                  and st.get("firing")]
        print(f"slo: {len(slo)} spec(s), {len(firing)} firing"
              + (" — " + ", ".join(st.get("name", "?") for st in firing)
                 if firing else ""), file=out)
    health = payload.get("health")
    if isinstance(health, dict) and health and "error" not in health:
        verdicts = Counter((rep or {}).get("verdict", "?")
                           for rep in health.values())
        print("health: " + "  ".join(f"{v}:{n}" for v, n in
                                     sorted(verdicts.items())), file=out)
    wal = payload.get("wal")
    if isinstance(wal, dict) and "error" not in wal:
        print(f"wal: seq {wal.get('seq')}  snap_seq {wal.get('snap_seq')}  "
              f"state_hash {wal.get('state_hash')}", file=out)
    env = payload.get("env")
    if isinstance(env, dict):
        n_red = sum(1 for v in env.values() if v == "<redacted>")
        print(f"env: {len(env)} key(s) captured"
              + (f", {n_red} redacted" if n_red else ""), file=out)

    costs = payload.get("costs")
    if isinstance(costs, dict) and "error" not in costs:
        counters = ((payload.get("metrics") or {}).get("counters") or {})
        _render_cost_panel(costs, counters, out)
    return 0


def show_lint(report, out=None):
    """Render an analyzer report (``python -m hyperopt_tpu_torch.analysis
    --json``)
    grouped by rule, new findings first, stale/invalid baseline rows last."""
    out = out or sys.stdout
    by_rule = {}
    for key in ("new", "baselined"):
        for f in report.get(key, ()):
            by_rule.setdefault(f["rule"], []).append((key, f))
    for rule in sorted(by_rule):
        rows = by_rule[rule]
        n_new = sum(1 for k, _ in rows if k == "new")
        print(f"{rule}: {len(rows)} finding(s), {n_new} new", file=out)
        for key, f in sorted(rows, key=lambda kf: (kf[0] != "new",
                                                   kf[1]["file"],
                                                   kf[1]["line"])):
            tag = "NEW " if key == "new" else "base"
            print(f"  [{tag}] {f['file']}:{f['line']} "
                  f"[{f['symbol']}] {f['message']}", file=out)
    for e in report.get("stale", ()):
        print(f"stale baseline entry: {e['rule']} {e['file']} "
              f"[{e['symbol']}] — finding no longer fires; delete it",
              file=out)
    for err in report.get("baseline_errors", ()):
        print(f"baseline error: {err}", file=out)
    counts = report.get("counts", {})
    print(f"{sum(counts.values())} finding(s): "
          f"{len(report.get('new', ()))} new, "
          f"{len(report.get('baselined', ()))} baselined, "
          f"{len(report.get('stale', ()))} stale; counts {counts}",
          file=out)
    if report.get("baseline_errors"):
        return 2
    return 1 if (report.get("new") or report.get("stale")) else 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "trace":
        # Subcommand form (`hyperopt-tpu-torch-show trace <dir>`); the
        # flag-based trials inspection below keeps its historical interface.
        tp = argparse.ArgumentParser(prog="hyperopt-tpu-torch-show trace",
                                     description="summarize a trace dir, or "
                                                 "--merge several into one "
                                                 "Perfetto trace")
        tp.add_argument("trace_dir", nargs="?", default=None,
                        help="fmin(..., trace_dir=...) output")
        tp.add_argument("--merge", nargs="+", metavar="DIR", default=None,
                        help="stitch these processes' loop_events.jsonl "
                             "into one clock-normalized Chrome trace")
        tp.add_argument("-o", "--out", default="merged_trace.json",
                        help="output path for --merge "
                             "(default: merged_trace.json)")
        targs = tp.parse_args(argv[1:])
        if targs.merge:
            merge_traces(targs.merge, out_path=targs.out)
            return 0
        if targs.trace_dir is None:
            tp.error("a trace dir (or --merge DIR...) is required")
        summarize_trace(targs.trace_dir)
        return 0

    if argv and argv[0] == "wal":
        wp = argparse.ArgumentParser(prog="hyperopt-tpu-torch-show wal",
                                     description="summarize a suggestion-"
                                                 "service WAL directory "
                                                 "(snapshot + tail records)")
        wp.add_argument("wal_dir", help="ServiceServer --wal-dir")
        wp.add_argument("--json", action="store_true",
                        help="emit the raw inspect() dict")
        wargs = wp.parse_args(argv[1:])
        return show_wal(wargs.wal_dir, as_json=wargs.json)

    if argv and argv[0] == "bundle":
        bp = argparse.ArgumentParser(prog="hyperopt-tpu-torch-show bundle",
                                     description="render a flight-recorder "
                                                 "postmortem bundle "
                                                 "directory")
        bp.add_argument("bundle_dir", help="bundle directory (a flight-"
                                           "recorder dump or a NetTrials"
                                           ".bundle(out_dir=...) pull)")
        bargs = bp.parse_args(argv[1:])
        return show_bundle(bargs.bundle_dir)

    if argv and argv[0] == "live":
        lp = argparse.ArgumentParser(prog="hyperopt-tpu-torch-show live",
                                     description="poll a netstore server's "
                                                 "fleet metrics into a "
                                                 "terminal dashboard")
        lp.add_argument("url", help="netstore server url, e.g. "
                                    "http://host:8999")
        lp.add_argument("--token", default=None,
                        help="X-Netstore-Token of the server")
        lp.add_argument("--interval", type=float, default=2.0)
        lp.add_argument("--once", action="store_true",
                        help="print a single frame and exit")
        largs = lp.parse_args(argv[1:])
        return live(largs.url, token=largs.token or None,
                    interval=largs.interval, once=largs.once)

    if argv and argv[0] == "lint":
        ap = argparse.ArgumentParser(prog="hyperopt-tpu-torch-show lint",
                                     description="render an invariant-"
                                                 "analyzer report (or run "
                                                 "the analyzers now)")
        ap.add_argument("report", nargs="?", default=None,
                        help="saved `python -m hyperopt_tpu_torch.analysis "
                             "--json` output; omit to analyze --root")
        ap.add_argument("--root", default=".",
                        help="repo root to analyze when no report file "
                             "is given (default: cwd)")
        ap.add_argument("--baseline", default=None,
                        help="baseline file (default: the repo's "
                             "hyperopt_tpu_torch/analysis/baseline.json)")
        largs = ap.parse_args(argv[1:])
        if largs.report:
            with open(largs.report, "r", encoding="utf-8") as f:
                report = json.load(f)
        else:
            from .analysis import default_baseline_path
            from .analysis.__main__ import build_report
            root = os.path.abspath(largs.root)
            report = build_report(
                root, largs.baseline or default_baseline_path(root))
        return show_lint(report)

    p = argparse.ArgumentParser(prog="hyperopt-tpu-torch-show",
                                description="inspect a hyperopt_tpu_torch "
                                            "experiment")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--root", help="file-store experiment root")
    src.add_argument("--pickle", help="trials_save_file pickle")
    p.add_argument("--exp-key", default="default")
    p.add_argument("--plot", default=None,
                   help="write a loss-history PNG to this path")
    args = p.parse_args(argv)

    if args.root:
        from .parallel.filestore import FileTrials
        trials = FileTrials(args.root, exp_key=args.exp_key)
    else:
        with open(args.pickle, "rb") as f:
            trials = pickle.load(f)
        trials.refresh()

    summarize(trials)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg", force=True)
        from . import plotting
        ax = plotting.main_plot_history(trials, do_show=False)
        ax.figure.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
