"""The obs core of the PyTorch port (``hyperopt_tpu_torch/obs/``), mirroring
``tests/test_obs.py`` (without ``TestMetricsEndpoint``: the metrics
endpoint belongs to the service slice):

* ``TestEventLog``, ``TestChromeTrace``, ``TestTracer`` and
  ``TestMetricsRegistry``: the JAX file's checks on the port's event log,
  Chrome export, tracer and registry, including its bound on the disabled
  path's cost (5 µs per span or update, its threshold);
* ``TestFminTraceDir``: ``fmin(trace_dir=)`` on the CPU writes the three
  host artifacts and the ``torch.profiler`` export; and the same hosted
  ``fmin`` (random startup, then TPE, same ``rstate``, a small space) run
  through both packages gives the same sequence of event types and trial
  ids, and equal values for every metric both registries hold
  (tolerance: none, equality; time-valued metrics, whose names end in
  ``_ms`` or ``_per_sec``, are compared by their sample counts only; the
  kernel cache's requests are equal, and each package's ``compile``
  events equal its own misses, which depend on what the process built
  before).
"""

import json
import os
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu.obs import events as events_j
from hyperopt_tpu.obs import metrics as metrics_j
from hyperopt_tpu_torch.obs import NullTracer, Tracer
from hyperopt_tpu_torch.obs import metrics, trace
from hyperopt_tpu_torch.obs.events import EVENT_TYPES, EVENTS, EventLog
from hyperopt_tpu_torch.obs.metrics import MetricsRegistry

hp = ht.hp


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------


class TestEventLog:
    def test_disabled_log_records_nothing(self):
        log = EventLog(capacity=16)
        assert not log.enabled
        assert log.emit("trial_start", trial=0) is None
        with log.span("s"):
            pass
        assert len(log) == 0 and log.n_emitted == 0

    def test_ring_buffer_keeps_most_recent(self):
        log = EventLog(capacity=8)
        log.enable()
        for i in range(20):
            log.emit("suggest", n=i)
        assert len(log) == 8
        assert log.n_emitted == 20 and log.n_dropped == 12
        assert [e["n"] for e in log.snapshot()] == list(range(12, 20))

    def test_default_capacity_is_an_argument(self):
        assert EventLog().capacity == 65536
        assert EventLog(capacity=3).capacity == 3

    def test_wall_derived_from_mono_anchor(self):
        log = EventLog(capacity=16)
        log.enable()
        a = log.emit("trial_start", trial=0)
        time.sleep(0.01)
        b = log.emit("trial_end", trial=0)
        assert (b["t_wall"] - a["t_wall"]) == pytest.approx(
            b["t_mono"] - a["t_mono"], abs=1e-6)

    def test_vocabulary_equals_jax(self):
        assert EVENT_TYPES == events_j.EVENT_TYPES

    def test_span_nesting_and_ordering_two_threads(self):
        log = EventLog(capacity=1024)
        log.enable()
        barrier = threading.Barrier(2)

        def work(tid):
            barrier.wait()
            for _ in range(25):
                with log.span("outer", trial=tid):
                    log.emit("trial_start", trial=tid)
                    with log.span("inner", trial=tid):
                        log.emit("suggest", trial=tid)
                    log.emit("trial_end", trial=tid)

        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"obs-w{i}") for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        events = log.snapshot()
        assert len(events) == 2 * 25 * 7
        begins = [e for e in events if e["type"] == "span_begin"]
        assert len({e["span"] for e in begins}) == len(begins)
        for tname in ("obs-w0", "obs-w1"):
            seq = sorted((e for e in events if e["thread"] == tname),
                         key=lambda e: e["t_mono"])
            assert [e["type"] for e in seq] == [
                "span_begin", "trial_start", "span_begin", "suggest",
                "span_end", "trial_end", "span_end"] * 25
            for j in range(0, len(seq), 7):
                (ob, ts, ib, sg, ie, te, oe) = seq[j:j + 7]
                assert ib["parent"] == ob["span"]
                assert oe["span"] == ob["span"] and oe["parent"] is None
                assert ie["span"] == ib["span"]
                assert ts["span"] == ob["span"]
                assert sg["span"] == ib["span"]
                assert te["span"] == ob["span"]


# ---------------------------------------------------------------------------
# chrome trace export
# ---------------------------------------------------------------------------


class TestChromeTrace:
    def _populated_log(self):
        log = EventLog(capacity=256)
        log.enable()
        with log.span("suggest", trial=0):
            log.emit("compile", name="tpe_kernel", key="(k,)")
        with log.span("evaluate", trial=0):
            time.sleep(0.002)
        log.emit("store_flush", name="json")
        return log

    def test_schema_round_trip(self, tmp_path):
        log = self._populated_log()
        path = tmp_path / "chrome_trace.json"
        n = log.export_chrome_trace(path)
        doc = json.loads(path.read_text())
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        evs = doc["traceEvents"]
        assert len(evs) == n
        for e in evs:
            assert {"name", "ph", "ts", "pid", "tid", "cat"} <= set(e)
            assert e["ph"] in ("X", "i")
        ts = [e["ts"] for e in evs]
        assert ts == sorted(ts)
        spans = {e["name"]: e for e in evs if e["ph"] == "X"}
        assert set(spans) == {"suggest", "evaluate"}
        assert spans["evaluate"]["dur"] >= 1e3
        cats = {e["cat"] for e in evs if e["ph"] == "i"}
        assert {"hyperopt_tpu:compile", "hyperopt_tpu:store_flush"} <= cats

    def test_same_conversion_as_jax(self):
        log = self._populated_log()
        events = log.snapshot()
        got = log.to_chrome_trace(events)
        want = events_j.events_to_chrome(events, pid=os.getpid())[0]
        assert got["traceEvents"] == want

    def test_unmatched_spans_stay_loadable(self):
        log = self._populated_log()
        events = log.snapshot()
        first_begin = next(e for e in events if e["type"] == "span_begin")
        doc = log.to_chrome_trace([e for e in events if e is not first_begin])
        assert [e["name"] for e in doc["traceEvents"]
                if e["ph"] == "X"] == ["evaluate"]
        last_end = [e for e in events if e["type"] == "span_end"][-1]
        doc2 = log.to_chrome_trace([e for e in events if e is not last_end])
        assert "hyperopt_tpu:span_open" in {e["cat"]
                                            for e in doc2["traceEvents"]}


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class TestTracer:
    def test_span_totals_survive_two_thread_overlap(self):
        tracer = Tracer(trace_dir=None, events=EventLog(capacity=1))
        n_threads, n_spans = 4, 300
        barrier = threading.Barrier(n_threads)

        def work():
            barrier.wait()
            for _ in range(n_spans):
                with tracer.span("work"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert tracer.counts["work"] == n_threads * n_spans
        assert tracer.totals["work"] > 0.0

    def test_nested_spans_attribute_only_top_level(self):
        tracer = Tracer(trace_dir=None, events=EventLog(capacity=64))
        with tracer.span("outer"):
            with tracer.span("inner"):
                time.sleep(0.002)
        tracer.set_wall(tracer.totals["outer"])
        att = tracer.attribution()
        assert att["attributed_s"] == pytest.approx(tracer.totals["outer"],
                                                    abs=1e-5)
        assert att["coverage"] == pytest.approx(1.0, abs=0.01)

    def test_dump_writes_artifacts_and_disarms(self, tmp_path):
        log = EventLog(capacity=256)
        d = tmp_path / "trace"
        tracer = Tracer(str(d), device_trace=True, events=log, device="cpu")
        assert log.enabled
        tracer.start_device_trace()
        with tracer.span("suggest", trial=0):
            torch.ones(4).sum()
        tracer.stop_device_trace()
        tracer.dump()
        summary = json.loads((d / "loop_trace.json").read_text())
        assert {"suggest", "_wall"} <= set(summary)
        assert all(json.loads(ln)["type"] for ln in
                   (d / "loop_events.jsonl").read_text().splitlines())
        assert json.loads((d / "chrome_trace.json").read_text())[
            "traceEvents"]
        prof = json.loads((d / trace.PROFILER_TRACE).read_text())
        assert prof["traceEvents"]
        assert not log.enabled and len(log) == 0

    def test_profiler_failure_raises(self, tmp_path, monkeypatch):
        import torch.profiler

        def broken(*args, **kwargs):
            raise RuntimeError("no profiler here")

        monkeypatch.setattr(torch.profiler, "profile", broken)
        tracer = Tracer(str(tmp_path), device_trace=True,
                        events=EventLog(capacity=8), device="cpu")
        with pytest.raises(RuntimeError, match="no profiler"):
            tracer.start_device_trace()
        tracer.dump()

    def test_null_tracer_span_is_shared_noop(self):
        nt = NullTracer()
        s1, s2 = nt.span("a"), nt.span("b", trial=3)
        assert s1 is s2
        with s1:
            pass
        assert nt.totals == {} and nt.dump() is None

    def test_disabled_path_overhead_bound(self):
        """The JAX file's bound: NullTracer spans and disabled-registry
        updates under 5 µs each."""
        nt = NullTracer()
        n = 20000
        t0 = time.perf_counter()
        for _ in range(n):
            with nt.span("x"):
                pass
        span_cost = (time.perf_counter() - t0) / n
        reg = MetricsRegistry(enabled=False)
        c = reg.counter("c")
        h = reg.histogram("h")
        t0 = time.perf_counter()
        for _ in range(n):
            c.inc()
            h.observe(0.5)
        metric_cost = (time.perf_counter() - t0) / n
        assert span_cost < 5e-6
        assert metric_cost < 5e-6
        assert c.value == 0.0 and h.summary() == {"count": 0}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class TestMetricsRegistry:
    def test_counters_gauges_histograms_snapshot(self):
        reg = MetricsRegistry(enabled=True)
        reg.counter("fmin.trials.done").inc()
        reg.counter("fmin.trials.done").inc(2)
        reg.gauge("fmin.trials_per_sec").set(41.5)
        h = reg.histogram("suggest.dispatch_ms")
        for v in (0.001, 0.002, 0.004):
            h.observe(v)
        snap = reg.snapshot()
        assert snap["enabled"] is True
        assert snap["counters"]["fmin.trials.done"] == 3.0
        assert snap["gauges"]["fmin.trials_per_sec"] == 41.5
        hs = snap["histograms"]["suggest.dispatch_ms"]
        assert hs["count"] == 3 and hs["sum"] == pytest.approx(0.007)
        assert hs["min"] == 0.001 and hs["max"] == 0.004
        assert reg.counter("fmin.trials.done") is reg.counter(
            "fmin.trials.done")
        reg.reset()
        assert reg.snapshot()["counters"]["fmin.trials.done"] == 0.0

    def test_same_snapshot_and_merge_as_jax(self):
        regs = (MetricsRegistry(enabled=True),
                metrics_j.MetricsRegistry(enabled=True))
        rng = np.random.default_rng(0)
        vals = rng.exponential(0.01, 50).tolist()
        for reg in regs:
            reg.counter("a").inc(3)
            reg.gauge("g").set(2.5)
            for v in vals:
                reg.histogram("h").observe(v)
        got, want = (r.snapshot(states=True) for r in regs)
        assert got == want
        assert metrics.merge_snapshots([got, got]) == \
            metrics_j.merge_snapshots([want, want])

    def test_kernel_cache_always_on_even_when_disabled(self):
        reg = MetricsRegistry(enabled=False)
        reg.counter("ignored").inc()
        key = ("u", 3, True)
        reg.kernel_cache_event(key, hit=False)
        reg.kernel_cache_event(key, hit=True)
        assert reg.kernel_cache_stats() == {
            "requests": 2, "misses": 1,
            "by_key": {repr(key): {"requests": 2, "misses": 1}}}
        assert reg.snapshot()["counters"]["ignored"] == 0.0
        reg.kernel_cache_stats(reset=True)
        assert reg.kernel_cache_stats()["requests"] == 0

    def test_set_enabled_switches_the_process_registry(self):
        reg = metrics.registry()
        c = reg.counter("obs_test.switch")
        before = c.value
        metrics.set_enabled(False)
        try:
            assert not metrics.metrics_enabled()
            c.inc()
            assert c.value == before
        finally:
            metrics.set_enabled(True)
        c.inc()
        assert c.value == before + 1

    def test_label_lru_evicts_and_counts(self):
        reg = MetricsRegistry(enabled=True)
        lru = metrics.LabelLru(cap=2, reg=reg)
        assert lru.touch("a") == [] and lru.touch("b") == []
        assert lru.touch("c") == ["a"]
        assert reg.snapshot()["counters"]["obs.series_evicted"] == 1.0
        assert metrics.LabelLru().cap == 256


# ---------------------------------------------------------------------------
# end to end: fmin(trace_dir=...)
# ---------------------------------------------------------------------------


def _space(pkg):
    # Bounds no other test uses: both packages memoize compiled spaces (and
    # their TPE kernels) by structure, so a fresh one builds its kernel.
    return {"x": pkg.hp.uniform("x", -4.75, 5.25),
            "c": pkg.hp.choice("c", [0, 1, 2])}


def _obj(p):
    return float(np.float32(p["x"] - 1.0) ** 2 + np.float32(p["c"]))


#: Random startup for 5 trials, then 11 TPE steps in one history bucket
#: (below the ring's pregrow band): no kernel is built but the first.
_N, _STARTUP = 16, 5


def _events(path):
    return [json.loads(ln) for ln in open(path)][1:]


class TestFminTraceDir:
    def test_fmin_emits_trace_artifacts(self, tmp_path):
        d = tmp_path / "trace"
        t = ht.Trials()

        def obj(p):
            time.sleep(0.01)
            return (p["x"] - 1.0) ** 2

        ht.fmin(obj, {"x": hp.uniform("x", -5, 5)},
                algo=ht.tpe.suggest, max_evals=8, trials=t,
                rstate=np.random.default_rng(0), show_progressbar=False,
                trace_dir=str(d), device="cpu")
        assert {"loop_trace.json", "loop_events.jsonl", "chrome_trace.json",
                trace.PROFILER_TRACE} <= set(os.listdir(d))
        summary = json.loads((d / "loop_trace.json").read_text())
        for phase in ("suggest", "evaluate", "store", "save"):
            assert summary[phase]["count"] == 8
        wall = summary["_wall"]
        assert 0.0 < wall["attributed_s"] <= wall["wall_s"] * 1.001
        assert wall["coverage"] >= 0.95
        lines = _events(d / "loop_events.jsonl")
        assert sum(e["type"] == "trial_end" for e in lines) == 8
        chrome = json.loads((d / "chrome_trace.json").read_text())
        assert any(e["ph"] == "X" and e["name"] == "evaluate"
                   for e in chrome["traceEvents"])
        prof = json.loads((d / trace.PROFILER_TRACE).read_text())
        assert prof["traceEvents"]
        assert not EVENTS.enabled
        assert metrics.registry().snapshot()["gauges"][
            "fmin.trials_per_sec"] > 0.0

    def test_events_and_metrics_equal_jax(self, tmp_path, monkeypatch):
        # The JAX side without its device profiler (it imports TensorFlow's
        # profiler, seconds of start-up): the host artifacts are compared.
        monkeypatch.setenv("HYPEROPT_TPU_DEVICE_TRACE", "0")
        runs = {}
        for name, pkg, reg, kw in (
                ("jax", hj, metrics_j.registry(), {}),
                ("torch", ht, metrics.registry(), {"device": "cpu"})):
            before = reg.snapshot()
            d = tmp_path / name
            t = pkg.Trials()
            pkg.fmin(_obj, _space(pkg),
                     algo=partial(pkg.tpe.suggest, n_startup_jobs=_STARTUP),
                     max_evals=_N, trials=t,
                     rstate=np.random.default_rng(3),
                     show_progressbar=False, trace_dir=str(d), **kw)
            runs[name] = (_moved(before, reg.snapshot()),
                          _events(d / "loop_events.jsonl"),
                          sorted(os.listdir(d)))
        (moved_j, ev_j, files_j), (moved_t, ev_t, files_t) = (
            runs["jax"], runs["torch"])
        assert files_t == sorted(files_j + [trace.PROFILER_TRACE])

        def seq(evs):
            # A kernel-cache miss emits "compile"; whether a package misses
            # depends on what the process built before, so those events
            # are held against each package's own miss count instead.
            return [(e["type"], e.get("name"), e.get("trial")) for e in evs
                    if e["type"] != "compile"]

        assert seq(ev_t) == seq(ev_j)
        for evs, moved in ((ev_t, moved_t), (ev_j, moved_j)):
            assert sum(e["type"] == "compile" for e in evs) == \
                moved["kernel_cache"][1]
        assert {e["type"] for e in ev_t} <= EVENT_TYPES

        shared = (set(moved_t) & set(moved_j)) - {"kernel_cache"}
        for key in shared:
            assert moved_t[key] == moved_j[key], key
        assert moved_t["kernel_cache"][0] == moved_j["kernel_cache"][0]
        assert {("counters", k) for k in (
            "fmin.batches", "fmin.trials.done", "history.upload_bytes",
            "history.append_hits", "history.rebuilds")} <= shared
        assert {("histograms", k) for k in (
            "suggest.upload_ms", "suggest.dispatch_ms",
            "suggest.fetch_sync_ms")} <= shared
        assert moved_t["kernel_cache"][0] == _N - _STARTUP
        assert moved_t[("counters", "fmin.batches")] == _N


def _moved(before, after):
    """What a run moved in a registry: counter deltas, histogram sample
    counts, gauges it set, and the kernel-cache request and miss deltas.
    Time-valued series (names ending in ``_ms`` or ``_per_sec``) keep only
    their sample counts."""
    out = {}
    for table in ("counters", "gauges"):
        for k, v in after[table].items():
            v0 = before[table].get(k)
            if k.endswith(("_ms", "_per_sec")) or v == v0:
                continue
            out[(table, k)] = v - (v0 or 0) if table == "counters" else v
    for k, h in after["histograms"].items():
        n = h["count"] - before["histograms"].get(k, {}).get("count", 0)
        if n:
            out[("histograms", k)] = n
    kc, kc0 = after["kernel_cache"], before["kernel_cache"]
    out["kernel_cache"] = (kc["requests"] - kc0["requests"],
                           kc["misses"] - kc0["misses"])
    return out
