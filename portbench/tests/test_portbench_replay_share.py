"""The per-layer metrics of the hosted step's CUDA graphs
(``metrics/tpe.replay_share.py``, ``metrics/setup.capture_s.py``): each
against a hand-made span summary or counter, and None where the program
has nothing to read (no traced segment, no span store, no such span or
counter: the parent of the change that adds them); the share reads 0
where the program has hosted graphs and no step replayed."""

import pytest

from portbench import harness, spans
from portbench.window import Traced

NEW = ("tpe.replay_share", "setup.capture_s")


def _read(name, run):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py").read(run)


def _run(traced=True):
    class Run:
        pass

    run = Run()
    run.traced = Traced(reduced={}, steps=200) if traced else None
    return run


#: A traced study: 180 TPE steps, 179 of them replays.
SUMMARY = {
    "tpe.suggest": {"count": 200, "total_ns": 400_000_000,
                    "self_ns": 40_000_000},
    "tpe.step": {"count": 180, "total_ns": 90_000_000, "self_ns": 9_000_000},
    "tpe.step.replay": {"count": 179, "total_ns": 81_000_000,
                        "self_ns": 81_000_000},
}


def test_every_new_metric_has_its_file_and_entry():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, layer, moves in (
            ("tpe.replay_share", "step dispatch", "suggest_p50_ms"),
            ("setup.capture_s", "setup", "setup_s")):
        assert (harness.HERE / "metrics" / f"{name}.py").exists()
        assert entries[name]["workloads"] == ["branin2.studies200"]
        assert entries[name]["source"] == "program_counter"
        assert entries[name]["layer"] == layer
        assert entries[name]["moves"] == moves


def test_replay_share_reads_the_span_counts(monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    assert _read("tpe.replay_share", _run()) == pytest.approx(179 / 180)


def test_capture_s_reads_the_counter(monkeypatch):
    monkeypatch.setattr(spans, "counter",
                        {"tpe.graph.capture_ms": 123.5}.get)
    assert _read("setup.capture_s", _run()) == pytest.approx(0.1235)
    # A process total: it reads without a traced segment too.
    assert _read("setup.capture_s", _run(False)) == pytest.approx(0.1235)


@pytest.mark.parametrize("summary", [
    None, {},
    {k: v for k, v in SUMMARY.items() if k != "tpe.step.replay"},
    {k: v for k, v in SUMMARY.items() if k != "tpe.step"},
    dict(SUMMARY, **{"tpe.step": {"count": 0, "total_ns": 0,
                                  "self_ns": 0}}),
], ids=["no-store", "empty", "no-replay-span", "no-step-span", "no-steps"])
def test_replay_share_reads_none_without_its_spans(monkeypatch, summary):
    # A program without hosted graphs: no tpe.graph.replays counter.
    monkeypatch.setattr(spans, "summary", lambda: summary)
    monkeypatch.setattr(spans, "counter", {}.get)
    assert _read("tpe.replay_share", _run()) is None


@pytest.mark.parametrize("replays", [0.0, 12.0])
def test_replay_share_reads_zero_when_no_step_replays(monkeypatch, replays):
    """A program with hosted graphs whose traced steps all ran eagerly
    (the counter may count replays outside the segment)."""
    summary = {k: v for k, v in SUMMARY.items() if k != "tpe.step.replay"}
    monkeypatch.setattr(spans, "summary", lambda: summary)
    monkeypatch.setattr(spans, "counter",
                        {"tpe.graph.replays": replays}.get)
    assert _read("tpe.replay_share", _run()) == 0.0
    # No step at all is still nothing to read.
    monkeypatch.setattr(spans, "summary", lambda: {})
    assert _read("tpe.replay_share", _run()) is None


def test_replay_share_reads_none_without_a_traced_segment(monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    assert _read("tpe.replay_share", _run(False)) is None


def test_capture_s_reads_none_without_the_counter(monkeypatch):
    monkeypatch.setattr(spans, "counter", {}.get)
    assert _read("setup.capture_s", _run()) is None
