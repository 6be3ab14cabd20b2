"""The cell ``flagship50.hosted`` (configuration ``flagship50r1000``, traffic
``resume24``) and its two per-layer metrics, on the CPU.

The cell's own files are found by name; then, from temporary copies of
them cut to a tiny size (the flagship space at ``n_dims`` 10, 60 resumed
trials, 4 more a study, 64 candidates: every proposal at histories 60-63,
the top quarter of bucket 64), a whole run reads ``correct`` and reports
its metrics, a traced run reads the new metrics from the program's spans,
and three faults planted in what the timed path produces each turn
``correct`` false: one proposal altered, one loss scaled by 1 + 1e-9, one
value put outside its support.  The metrics' arithmetic is held against a
hand-made summary, and reads None where the program has nothing to read.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from portbench import check, harness, spans
from portbench.drivers import hosted
from portbench.window import Traced

from .test_portbench_spans import CpuSegment

WORKLOAD = "flagship50.hosted"
CONFIG, TRAFFIC = "flagship50r1000", "resume24"
NEW = ("trials.parse_ms", "tpe.card_ms_per_step")
TINY_CONFIG = {"n_dims": 10, "n_history": 60, "n_EI_candidates": 64}
TINY_TRAFFIC = {"study_more": 4}
SEED = 2 ** 31 + 4242


def _read(name, run):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py").read(run)


def _bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The harness reading a copy of ``portbench/`` whose configuration
    and traffic files of the cell are cut to the tiny size."""
    pb = tmp_path / "portbench"
    shutil.copytree(harness.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub, name, cut in (("configs", CONFIG, TINY_CONFIG),
                           ("traffic", TRAFFIC, TINY_TRAFFIC)):
        path = pb / sub / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **cut)))
    monkeypatch.setattr(harness, "HERE", pb)

    def cell(seed=SEED):
        return harness.load_cell(_bench(), WORKLOAD, seed, "cpu")

    return cell


def test_harness_finds_the_cells_files_by_name():
    bench = _bench()
    entry = next(w for w in bench["workloads"] if w["name"] == WORKLOAD)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        CONFIG, TRAFFIC, 1)
    conf = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert conf["file"] == f"portbench/configs/{CONFIG}.json"
    assert conf["reduced"] == []
    cell = harness.load_cell(bench, WORKLOAD, SEED, "cpu")
    assert cell.config["n_history"] == 1000
    assert cell.config["n_EI_candidates"] == 10000
    assert cell.traffic["driver"] == "hosted"
    assert cell.traffic["study_more"] == 24
    assert set(cell.limits) == {"ei_gap", "loss_rel_err", "active_mismatch",
                                "support_violations"}
    # The published widths: 53 parameters, 31 of them density columns.
    kinds = [p["kind"] for p in cell.ps]
    assert len(kinds) == cell.config["shape"]["parameters"] == 53
    per_layer = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD,
                                                         "per_layer")}
    assert set(NEW) <= per_layer
    assert {"ei_scores.k1_roofline", "tpe.kernels_per_step",
            "device.idle_share", "tpe.replay_share"} <= per_layer
    e2e = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD,
                                                   "end_to_end")}
    assert e2e == {"suggest_p50_ms", "suggest_p95_ms", "trials_per_s",
                   "setup_s"}
    for name in NEW:
        assert (harness.HERE / "metrics" / f"{name}.py").exists()


#: A traced segment of 24 proposals (times in ms).
SUMMARY = {
    "tpe.suggest": {"count": 24, "total_ns": 72_000_000,
                    "self_ns": 4_000_000},
    "tpe.history": {"count": 24, "total_ns": 30_000_000,
                    "self_ns": 6_000_000},
    "trials.parse": {"count": 24, "total_ns": 24_000_000,
                     "self_ns": 24_000_000},
}


def _run(traced=True, busy_s=0.012, steps=24):
    class Run:
        pass

    run = Run()
    run.traced = Traced(reduced={"busy_s": busy_s, "window_s": 0.5},
                        steps=steps) if traced else None
    return run


def test_metrics_read_a_hand_made_segment(monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    assert _read("trials.parse_ms", _run()) == pytest.approx(1.0)
    assert _read("tpe.card_ms_per_step", _run()) == pytest.approx(0.5)


@pytest.mark.parametrize("summary", [
    None, {}, {k: v for k, v in SUMMARY.items() if k != "trials.parse"},
    {k: v for k, v in SUMMARY.items() if k != "tpe.suggest"},
], ids=["no-store", "empty", "no-parse-span", "no-suggest-span"])
def test_parse_ms_reads_none_without_its_spans(monkeypatch, summary):
    # A program without the span (the parent of the change that adds it).
    monkeypatch.setattr(spans, "summary", lambda: summary)
    assert _read("trials.parse_ms", _run()) is None


def test_metrics_read_none_without_a_traced_segment(monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    for name in NEW:
        assert _read(name, _run(traced=False)) is None
    assert _read("tpe.card_ms_per_step", _run(steps=0)) is None


def test_tiny_run_is_correct_and_reports_its_metrics(tiny):
    cell = tiny()
    result, _ = harness.execute(_bench(), cell, 0.5, False)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["attempted"] % TINY_TRAFFIC["study_more"] == 0
    assert set(result["metrics"]) == {"suggest_p50_ms", "suggest_p95_ms",
                                      "trials_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_traced_tiny_study_reads_the_new_metrics_from_its_spans(tiny):
    from hyperopt_tpu_torch.obs import trace

    cell = tiny()
    trace.span_clear()
    state = hosted.setup(cell)
    run = harness.Run(cell)
    run.window = hosted.window(state, 0.2, 9)
    assert spans.summary() == {}
    run.traced = hosted.profile(state, CpuSegment())
    got = spans.summary()
    n = TINY_TRAFFIC["study_more"]
    assert run.traced.steps == got["tpe.suggest"]["count"] == n
    # The resumed study parses its 60 rows once, then one row a proposal.
    assert got["trials.parse"]["count"] == n
    assert got["trials.parse"]["parent"] == "tpe.history"
    assert got["history.rebuild"]["count"] == 1
    assert _read("trials.parse_ms", run) == pytest.approx(
        got["trials.parse"]["total_ns"] * 1e-6 / n)
    # No device operation on the CPU: the card's time reads 0.
    assert _read("tpe.card_ms_per_step", run) == 0.0
    trace.span_clear()


Kernel = hosted.program.tpe._TpeKernel
#: Set-up's warm study makes this many proposals and trials.
WARM = TINY_TRAFFIC["study_more"]


def _checked_window(cell):
    """Set-up, one window and its check: ``(correct, checks)``."""
    state = hosted.setup(cell)
    try:
        w = hosted.window(state, 0.3, 5)
        readings = hosted.check_window(state, w, np.random.default_rng(1))
    finally:
        hosted.close(state)
    return check.verdict(readings, cell.limits)


def _patch_one_step(monkeypatch, edit):
    """Run ``edit(kern, row)`` on a copy of the row of the window's second
    TPE step."""
    real = Kernel._suggest_lanes
    calls = []

    def step(self, *a, **k):
        row, act, best, ties = real(self, *a, **k)
        calls.append(1)
        if len(calls) == WARM + 2:
            row = edit(self, row.clone())
        return row, act, best, ties

    monkeypatch.setattr(Kernel, "_suggest_lanes", step)


def _pid(kern, label):
    return next(p.pid for p in kern.cs.params if p.label == label)


def test_one_proposal_altered_is_caught(tiny, monkeypatch):
    def edit(kern, row):
        row[:, _pid(kern, "u0")] += 0.75
        return row

    _patch_one_step(monkeypatch, edit)
    correct, checks = _checked_window(tiny())
    assert not correct
    assert checks["ei_gap"]["value"] > checks["ei_gap"]["limit"], checks


def test_one_value_outside_its_support_is_caught(tiny, monkeypatch):
    def edit(kern, row):
        row[:, _pid(kern, "u0")] = 5.5          # uniform(-5, 5)
        return row

    _patch_one_step(monkeypatch, edit)
    correct, checks = _checked_window(tiny())
    assert not correct
    assert checks["support_violations"]["value"] > 0, checks


def test_one_loss_scaled_is_caught(tiny, monkeypatch):
    real = hosted.host_objective

    def scaled_once(cell):
        fn, calls = real(cell), []

        def objective(cfg):
            calls.append(1)
            v = fn(cfg)
            return v * (1 + 1e-9) if len(calls) == WARM + 2 else v

        return objective

    monkeypatch.setattr(hosted, "host_objective", scaled_once)
    correct, checks = _checked_window(tiny())
    assert not correct
    assert 0 < checks["loss_rel_err"]["value"] <= 2e-9, checks
