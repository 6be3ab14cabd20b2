"""The port's span store (``hyperopt_tpu_torch/obs/trace.py``) and its sites
on the suggest path, on the CPU.

* Spans nest: each records its parent, its thread and the request id of
  the proposal it served, on every thread at once.
* Disarmed (no profiler, no Tracer with a trace dir), a site returns the
  one shared no-op context manager, records and keeps nothing, and costs
  under 0.5 µs over the ``with`` statement itself, in the loop of
  ``test_torch_obs.py::test_disabled_path_overhead_bound``.
* A CPU ``torch.profiler`` session arms the store: a hosted 30-trial
  ``fmin`` then holds every ``tpe.*`` span among the profiler's events as
  a range that is not a user annotation; one ``tpe.step`` per TPE step,
  one ``tpe.startup`` per startup proposal, and children that cover at
  least 90% of ``tpe.suggest``'s time.
* ``tpe.kernel_build_ms`` grows once per new history bucket and never on
  a warm step; ``tpe.cold_step_ms`` grows on each kernel's first step.
* ``fmin(trace_dir=)`` writes the nested names with ``self_s`` and their
  parent into ``loop_trace.json``; ``show trace`` prints the span tree and
  the card's idle time per innermost span, checked on a hand-made Chrome
  trace whose attribution is worked out by hand.
"""

import io
import json
import threading
import time
import tracemalloc
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import hp, show, tpe
from hyperopt_tpu_torch.obs import metrics, trace

#: Every span name of the hosted suggest path that a 30-trial study from
#: empty passes through (startup, then TPE steps in bucket 32).
TPE_SPANS = ("tpe.suggest", "tpe.history", "tpe.startup", "tpe.acquire",
             "tpe.kernel_build", "tpe.feed", "tpe.step", "tpe.step.draw",
             "tpe.step.split", "tpe.step.groups", "tpe.step.pick",
             "tpe.fetch", "tpe.docs")
N_TRIALS, N_STARTUP = 30, 20


@contextmanager
def profiling():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _space(tag):
    # A label of its own: compiled spaces (and their kernels) are shared by
    # structure within a process.
    return {f"x_{tag}": hp.uniform(f"x_{tag}", -5.0, 5.0)}


def _fmin(space, trials, **kw):
    return ht.fmin(lambda p: (next(iter(p.values())) - 1.0) ** 2, space,
                   algo=tpe.suggest, max_evals=kw.pop("max_evals", N_TRIALS),
                   trials=trials, rstate=np.random.default_rng(7),
                   show_progressbar=False, device="cpu", **kw)


def _counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


@pytest.fixture(scope="module")
def study():
    """One hosted 30-trial study under a CPU profiler session: the store's
    summary and ring, and the profiler's events."""
    assert not trace.armed()
    trace.span_clear()
    with profiling() as prof:
        assert trace.armed()
        _fmin(_space("study"), ht.Trials())
        tpe.wait_prewarm()
    assert not trace.armed()
    return trace.span_summary(), trace.recent_spans(), prof.events()


def test_spans_nest_with_parents_and_one_request_per_proposal():
    trace.span_clear()
    barrier = threading.Barrier(2)

    def proposals(base):
        barrier.wait()
        for k in range(5):
            with trace.span("outer", request=base + k):
                with trace.span("mid"):
                    with trace.span("inner"):
                        time.sleep(0.0005)
                with trace.span("mid"):
                    pass

    with profiling():
        threads = [threading.Thread(target=proposals, args=(b,))
                   for b in (100, 200)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    ring = trace.recent_spans()
    assert len(ring) == 2 * 5 * 4
    by_id = {s["id"]: s for s in ring}
    assert len({s["thread"] for s in ring}) == 2
    outers = [s for s in ring if s["name"] == "outer"]
    assert sorted(s["request"] for s in outers) == \
        [100 + k for k in range(5)] + [200 + k for k in range(5)]
    for s in ring:
        if s["name"] == "outer":
            assert s["parent"] is None
            continue
        parent = by_id[s["parent"]]
        assert parent["name"] == {"mid": "outer", "inner": "mid"}[s["name"]]
        assert parent["thread"] == s["thread"]
        assert parent["request"] == s["request"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
    agg = trace.span_summary()
    assert {n: a["count"] for n, a in agg.items()} == \
        {"outer": 10, "mid": 20, "inner": 10}
    assert agg["inner"]["parent"] == "mid" and agg["outer"]["parent"] is None
    assert agg["inner"]["self_ns"] == agg["inner"]["total_ns"]
    assert agg["mid"]["self_ns"] == \
        agg["mid"]["total_ns"] - agg["inner"]["total_ns"]
    assert agg["outer"]["self_ns"] == \
        agg["outer"]["total_ns"] - agg["mid"]["total_ns"]
    trace.span_clear()
    assert trace.span_summary() == {} and trace.recent_spans() == []


def test_disarmed_spans_record_nothing_allocate_nothing_and_cost_little():
    assert not trace.armed()
    trace.span_clear()
    null = trace.span("a")
    assert trace.span("b", request=3) is null
    assert ht.obs.NullTracer().span("c") is null
    n = 20000
    request = trace.current_request()
    # Only this thread's allocations: their tracebacks pass through this
    # file (other tests' threads may still run in the process).
    here = [tracemalloc.Filter(True, __file__, all_frames=True)]
    tracemalloc.start(8)
    try:
        before = tracemalloc.take_snapshot().filter_traces(here)
        for _ in range(n):
            with trace.span("x"):
                pass
            trace.set_request(5)
        after = tracemalloc.take_snapshot().filter_traces(here)
    finally:
        tracemalloc.stop()
    kept = [d for d in after.compare_to(before, "traceback")
            if d.size_diff > 0 and any(f.filename == trace.__file__
                                       for f in d.traceback)]
    assert kept == []
    assert trace.span_summary() == {} and trace.recent_spans() == []
    assert trace.current_request() == request

    def per_site(make):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                with make("x"):
                    pass
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    bare = per_site(lambda name: null)
    site = per_site(trace.span)
    assert site < 5e-6
    # The site's own work (the call and the armed check): the ``with`` on
    # a no-op manager is what any site pays.
    assert site - bare < 0.5e-6, (site, bare)


def test_profiler_session_records_every_tpe_span_as_a_host_range(study):
    summary, _, events = study
    assert set(TPE_SPANS) <= set(summary)
    seen = {}
    for e in events:
        if e.name in TPE_SPANS:
            seen.setdefault(e.name, set()).add(
                (e.is_user_annotation, e.device_type))
    assert set(seen) == set(TPE_SPANS)
    assert all(v == {(False, torch.autograd.DeviceType.CPU)}
               for v in seen.values()), seen


def test_hosted_fmin_has_one_step_per_tpe_step_and_children_cover(study):
    summary, ring, _ = study
    n_tpe = N_TRIALS - N_STARTUP
    counts = {n: summary[n]["count"] for n in summary}
    assert counts["tpe.suggest"] == N_TRIALS
    assert counts["tpe.startup"] == N_STARTUP
    for name in ("tpe.step", "tpe.acquire", "tpe.feed", "tpe.fetch",
                 "tpe.step.draw", "tpe.step.split", "tpe.step.groups",
                 "tpe.step.pick"):
        assert counts[name] == n_tpe, name
    assert counts["tpe.history"] == counts["tpe.docs"] == N_TRIALS
    for loop in ("suggest", "store", "evaluate", "save"):
        assert counts[loop] == N_TRIALS
    assert summary["tpe.suggest"]["parent"] == "suggest"
    assert summary["tpe.step.groups"]["parent"] == "tpe.step"
    sug = summary["tpe.suggest"]
    assert sug["self_ns"] <= 0.1 * sug["total_ns"], sug
    # Every span of a proposal carries its trial id; the prewarm build
    # carries the id of the proposal that started it.
    by_id = {s["id"]: s for s in ring}
    assert sorted(s["request"] for s in ring
                  if s["name"] == "tpe.suggest") == list(range(N_TRIALS))
    for s in ring:
        if s["parent"] in by_id:
            assert s["request"] == by_id[s["parent"]]["request"], s
    evaluates = [s["request"] for s in ring if s["name"] == "evaluate"]
    assert evaluates == list(range(N_TRIALS))


def test_kernel_build_counter_grows_once_per_bucket():
    space = _space("build")
    trials = ht.Trials()
    built0, cold0 = (_counter("tpe.kernel_build_ms"),
                     _counter("tpe.cold_step_ms"))
    _fmin(space, trials, max_evals=N_STARTUP + 1)
    tpe.wait_prewarm()
    built1, cold1 = (_counter("tpe.kernel_build_ms"),
                     _counter("tpe.cold_step_ms"))
    assert built1 > built0 and cold1 > cold0
    cs = ht.Domain(lambda p: 0.0, space).cs
    kernels = cs.__dict__["_tpe_kernels"]
    assert sorted(k[0] for k in kernels) == [32]
    # Warm steps in the built bucket: neither counter moves.
    _fmin(space, trials, max_evals=N_STARTUP + 4)
    tpe.wait_prewarm()
    assert _counter("tpe.kernel_build_ms") == built1
    assert _counter("tpe.cold_step_ms") == cold1
    # Past 75% of the bucket the prewarm builds bucket 64 once; its first
    # step (33 rows) is cold, the next ones are not.
    _fmin(space, trials, max_evals=34)
    tpe.wait_prewarm()
    built2, cold2 = (_counter("tpe.kernel_build_ms"),
                     _counter("tpe.cold_step_ms"))
    assert sorted(k[0] for k in kernels) == [32, 64]
    assert built2 > built1 and cold2 > cold1
    _fmin(space, trials, max_evals=37)
    tpe.wait_prewarm()
    assert _counter("tpe.kernel_build_ms") == built2
    assert _counter("tpe.cold_step_ms") == cold2


def test_trace_dir_writes_nested_spans_and_show_prints_the_tree(tmp_path):
    d = tmp_path / "trace"
    _fmin(_space("dir"), ht.Trials(), trace_dir=str(d))
    tpe.wait_prewarm()
    assert not trace.armed()
    doc = json.loads((d / "loop_trace.json").read_text())
    for name in ("suggest", "evaluate", "tpe.suggest", "tpe.step",
                 "tpe.step.groups"):
        assert {"total_s", "count", "mean_ms", "self_s",
                "parent"} <= set(doc[name]), name
    assert doc["suggest"]["parent"] is None
    assert doc["tpe.suggest"]["parent"] == "suggest"
    assert doc["tpe.step"]["count"] == N_TRIALS - N_STARTUP
    assert doc["suggest"]["self_s"] < doc["suggest"]["total_s"]
    buf = io.StringIO()
    show.summarize_spans(str(d), out=buf)
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("span tree")
    rows = {ln.strip().split()[0]: ln for ln in lines[1:]}
    assert rows["tpe.suggest"].startswith("  tpe.suggest")
    assert rows["tpe.step.groups"].startswith("      tpe.step.groups")
    # A CPU run's profiler export holds no device work: no idle table.
    assert not any(ln.startswith("card idle") for ln in lines)


def _hand_trace():
    """Spans A [0, 100] > B [10, 60] > C [20, 40] (µs) and kernels at
    [25, 35] and [70, 80].  Idle: [0, 25], [35, 70], [80, 100]; innermost
    span there: A [0, 10] + [60, 70] + [80, 100] = 40, B [10, 20] +
    [40, 60] = 30, C [20, 25] + [35, 40] = 10."""
    t0 = 1_000_000.0
    ev = [{"ph": "X", "cat": "cpu_op", "name": n, "ts": t0 + a, "dur": b - a,
           "pid": 1, "tid": 1}
          for n, a, b in (("A", 0, 100), ("B", 10, 60), ("C", 20, 40))]
    ev += [{"ph": "X", "cat": "kernel", "name": k, "ts": t0 + a, "dur": 10,
            "pid": 0, "tid": 7} for k, a in (("k1", 25), ("k2", 70))]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
               "ts": t0 + 22, "dur": 2, "pid": 1, "tid": 1})
    return ev


def test_show_names_the_cards_idle_time_by_the_innermost_span(tmp_path):
    idle = show.span_idle(_hand_trace(), {"A", "B", "C"})
    assert idle == pytest.approx({"A": 40e-6, "B": 30e-6, "C": 10e-6})
    # Without A, and with a span D [90, 100]: the window is [10, 100], and
    # [60, 70] and [80, 90] lie outside every span.
    extra = {"ph": "X", "cat": "cpu_op", "name": "D", "ts": 1_000_090.0,
             "dur": 10.0, "pid": 1, "tid": 1}
    idle = show.span_idle(_hand_trace() + [extra], {"B", "C", "D"})
    assert idle == pytest.approx({"B": 30e-6, "C": 10e-6, "D": 10e-6,
                                  "(no span)": 20e-6})
    assert show.span_idle(_hand_trace()[:3], {"A", "B", "C"}) == {}
    loop = {"A": {"total_s": 1e-4, "count": 1, "mean_ms": 0.1,
                  "self_s": 5e-5, "parent": None},
            "B": {"total_s": 5e-5, "count": 1, "mean_ms": 0.05,
                  "self_s": 3e-5, "parent": "A"},
            "C": {"total_s": 2e-5, "count": 1, "mean_ms": 0.02,
                  "self_s": 2e-5, "parent": "B"},
            "_wall": {"wall_s": 1e-4, "attributed_s": 1e-4,
                      "coverage": 1.0}}
    (tmp_path / "loop_trace.json").write_text(json.dumps(loop))
    (tmp_path / trace.PROFILER_TRACE).write_text(
        json.dumps({"traceEvents": _hand_trace()}))
    buf = io.StringIO()
    show.summarize_spans(str(tmp_path), out=buf)
    lines = buf.getvalue().splitlines()
    assert [ln.split()[0] for ln in lines[1:4]] == ["A", "B", "C"]
    assert lines[2].startswith("  B") and lines[3].startswith("    C")
    assert lines[4].startswith("card idle inside the innermost span "
                               "(0.0001 s")
    assert [ln.split()[:2] for ln in lines[5:]] == [
        ["A", "0.0000"], ["B", "0.0000"], ["C", "0.0000"]]
    assert [ln.split()[-1] for ln in lines[5:]] == ["50.0%", "37.5%",
                                                    "12.5%"]
