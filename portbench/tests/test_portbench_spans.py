"""The per-layer metrics that read the program's span store and setup
counters (``spans.py``, ``metrics/tpe.*_ms.py``, ``fmin.loop_self_ms.py``,
``setup.*_s.py``): each against a hand-made summary, None where the
program has nothing to read, and a tiny CPU run whose traced segment runs
under a CPU profiler session, which the summary holds alone."""

from contextlib import contextmanager

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.window import Traced

from .tiny import tiny_cell

NEW = ("tpe.history_ms", "tpe.feed_ms", "tpe.enqueue_ms",
       "tpe.fetch_wait_ms", "tpe.suggest_self_ms", "fmin.loop_self_ms",
       "setup.kernel_build_s", "setup.cold_step_s")


def _read(name, run):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py").read(run)


def _run(traced=True):
    class Run:
        pass

    run = Run()
    run.traced = Traced(reduced={}, steps=10) if traced else None
    return run


def _ns(ms):
    return int(ms * 1e6)


#: 10 proposals, 8 of them TPE steps, 10 trials (times in ms).
SUMMARY = {
    "suggest": {"count": 10, "total_ns": _ns(60.0), "self_ns": _ns(2.0)},
    "store": {"count": 10, "total_ns": _ns(3.0), "self_ns": _ns(3.0)},
    "save": {"count": 10, "total_ns": _ns(1.0), "self_ns": _ns(1.0)},
    "evaluate": {"count": 10, "total_ns": _ns(5.0), "self_ns": _ns(5.0)},
    "tpe.suggest": {"count": 10, "total_ns": _ns(58.0),
                    "self_ns": _ns(4.0)},
    "tpe.history": {"count": 10, "total_ns": _ns(6.0), "self_ns": _ns(5.0)},
    "tpe.feed": {"count": 8, "total_ns": _ns(4.0), "self_ns": _ns(4.0)},
    "tpe.step": {"count": 8, "total_ns": _ns(32.0), "self_ns": _ns(1.0)},
    "tpe.fetch": {"count": 8, "total_ns": _ns(8.0), "self_ns": _ns(8.0)},
}
COUNTERS = {"tpe.kernel_build_ms": 2500.0, "tpe.cold_step_ms": 400.0}
WANT = {"tpe.history_ms": 0.5, "tpe.feed_ms": 0.5, "tpe.enqueue_ms": 4.0,
        "tpe.fetch_wait_ms": 1.0, "tpe.suggest_self_ms": 0.4,
        "fmin.loop_self_ms": 0.6, "setup.kernel_build_s": 2.5,
        "setup.cold_step_s": 0.4}


def test_every_new_metric_has_its_file_and_entry():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert (harness.HERE / "metrics" / f"{name}.py").exists()
        assert entries[name]["workloads"] == ["branin2.studies200"]
        assert entries[name]["source"] == "program_counter"


@pytest.mark.parametrize("name", NEW)
def test_metric_reads_a_hand_made_summary(monkeypatch, name):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    monkeypatch.setattr(spans, "counter", COUNTERS.get)
    assert _read(name, _run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_metric_reads_none_without_the_programs_spans(monkeypatch, name):
    # A program without the store or the counters (the parent of the
    # change that adds them) reads as None, and so does a missing span.
    monkeypatch.setattr(spans, "summary", lambda: None)
    monkeypatch.setattr(spans, "counter", {}.get)
    assert _read(name, _run()) is None
    monkeypatch.setattr(spans, "summary", lambda: {
        k: v for k, v in SUMMARY.items() if k != "tpe.suggest"})
    if name.startswith(("tpe.history", "tpe.suggest")):
        assert _read(name, _run()) is None
    assert spans.per(_run(traced=False), "tpe.step", "total",
                     "tpe.step") is None


class CpuSegment:
    """The traced segment's profiler session, on the CPU."""

    @contextmanager
    def recording(self):
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            yield self
        finally:
            prof.stop()

    def reduce(self):
        return {"busy_s": 0.0, "window_s": 1.0, "kernels": 0, "k1_s": 0.0,
                "k1_launches": 0, "device_ops": [], "idle_gaps": []}


def test_tiny_run_reads_the_segments_spans_and_nothing_of_the_window():
    from hyperopt_tpu_torch.obs import trace

    from portbench.drivers import hosted

    _, cell = tiny_cell("branin2.studies200")
    trace.span_clear()
    state = hosted.setup(cell)
    run = harness.Run(cell)
    run.window = hosted.window(state, 0.3, 9)
    assert spans.summary() == {}
    run.traced = hosted.profile(state, CpuSegment())
    got = spans.summary()
    n = cell.traffic["study_more"]
    n_tpe = n - cell.config["tpe"]["n_startup_jobs"]
    assert run.traced.steps == n
    assert got["tpe.suggest"]["count"] == got["evaluate"]["count"] == n
    assert got["tpe.step"]["count"] == n_tpe
    for name in NEW:
        v = _read(name, run)
        assert v is not None and v >= 0.0, name
    assert _read("tpe.enqueue_ms", run) == pytest.approx(
        got["tpe.step"]["total_ns"] * 1e-6 / n_tpe)
