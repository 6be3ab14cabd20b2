"""The cell ``flagship50.fleet64`` at a tiny size on the CPU (4 lanes of 40
trials, stride 10, 64 candidates, the flagship space at ``n_dims`` 10):
a whole run reads ``correct`` and reports its metrics; three faults
planted in what the fleet lands each turn it false; the control (K2)
fails the cell's ``ei_gap`` limit where sound runs pass it; the fleet's
per-layer readers read a hand-made summary, and None where the program
has no span to read; a traced run reads them from the program's spans of
exactly one segment."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from hyperopt_tpu_torch import device, fleet

from portbench import calibrate, harness, spans
from portbench.drivers import fleet as fleet_driver
from portbench.reference import space as rspace
from portbench.window import Traced

WORKLOAD = "flagship50.fleet64"
SEEDS = (11, 2 ** 31 + 5, 40404)
TINY = {"n_dims": 10, "n_EI_candidates": 64}
TINY_TRAFFIC = {"n_lanes": 4, "max_evals": 40, "sync_stride": 10}
SPAN_METRICS = {"fleet.enqueue_ms": "fleet.run",
                "fleet.fetch_wait_ms": "fleet.fetch",
                "fleet.land_ms": "fleet.land"}


def _shrink(cell):
    cell.config = dict(cell.config, **TINY)
    cell.n_dims = TINY["n_dims"]
    cell.ps = rspace.params(cell.builder.build(rspace.PLAIN_HP, cell.n_dims))
    cell.labels = cell.builder.objective_labels(cell.n_dims)
    cell.settings.n_cand = TINY["n_EI_candidates"]
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)


def _tiny_cell(seed=2 ** 31 + 12345):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, WORKLOAD, seed, "cpu")
    _shrink(cell)
    return bench, cell


def _run(seconds=0.5):
    bench, cell = _tiny_cell()
    result, _ = harness.execute(bench, cell, seconds, False)
    return result


def _read(name, run):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py").read(run)


def test_tiny_run_is_correct_and_reports_its_metrics():
    result = _run()
    assert result["correct"], result["checks"]
    n = TINY_TRAFFIC["n_lanes"] * TINY_TRAFFIC["max_evals"]
    assert result["failed"] == 0 and result["attempted"] % n == 0
    assert set(result["metrics"]) == {"setup_s", "trials_per_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def _patch_land(monkeypatch, edit):
    """Run ``edit(cs, rows, losses)`` on copies of what the last lane lands
    at each run's last segment (the last trial of the last lane is always
    in the check's sample)."""
    real = device._land
    per_run = TINY_TRAFFIC["n_lanes"] * (TINY_TRAFFIC["max_evals"]
                                         // TINY_TRAFFIC["sync_stride"])
    calls = []

    def land(trials, cs, rows, acts, losses):
        calls.append(1)
        if len(calls) % per_run == 0:
            rows, losses = rows.copy(), losses.copy()
            edit(cs, rows, losses)
        return real(trials, cs, rows, acts, losses)

    monkeypatch.setattr(device, "_land", land)


def test_one_landed_value_altered(monkeypatch):
    # A normal column the objective does not read: only the step's own
    # check can see it.
    def edit(cs, rows, losses):
        pid = next(p.pid for p in cs.params if p.label == "n0")
        rows[-1, pid] += 0.5

    _patch_land(monkeypatch, edit)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["ei_gap"]["value"] > \
        result["checks"]["ei_gap"]["limit"]


def test_one_loss_scaled(monkeypatch):
    def edit(cs, rows, losses):
        losses[-1] *= np.float32(1 + 1e-4)

    _patch_land(monkeypatch, edit)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["loss_rel_err"]["value"] > \
        result["checks"]["loss_rel_err"]["limit"]


def test_lane_seeds_drawn_one_lane_on(monkeypatch):
    real = fleet.fmin_fleet

    def shifted(*a, seed=0, **k):
        return real(*a, seed=seed + 1, **k)

    monkeypatch.setattr(fleet, "fmin_fleet", shifted)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["ei_gap"]["value"] > \
        result["checks"]["ei_gap"]["limit"]


def test_control_fails_where_sound_runs_pass():
    limit = harness.load_json(harness.HERE / "checks" / f"{WORKLOAD}.json")[
        "limits"]["ei_gap"]["limit"]
    sound = [r for _, r in calibrate.readings(
        WORKLOAD, SEEDS, 0.2, device="cpu", tweak=_shrink)]
    control = [r for _, r in calibrate.readings(
        WORKLOAD, SEEDS, 0.2, control="bf16", device="cpu", tweak=_shrink)]
    assert all(r["ei_gap"] <= limit for r in sound), sound
    assert all(r["ei_gap"] > limit for r in control), control


def _ns(ms):
    return int(ms * 1e6)


SUMMARY = {"fleet.segment": {"count": 1, "total_ns": _ns(30.0)},
           "fleet.run": {"count": 1, "total_ns": _ns(5.0)},
           "fleet.fetch": {"count": 1, "total_ns": _ns(20.0)},
           "fleet.land": {"count": 1, "total_ns": _ns(4.0)}}


class _Run:
    def __init__(self, traced):
        self.traced = traced


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_reads_per_replay(monkeypatch, name):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    run = _Run(Traced(reduced={}, steps=10))
    want = SUMMARY[SPAN_METRICS[name]]["total_ns"] * 1e-6 / 10
    assert _read(name, run) == pytest.approx(want)
    # The parent of the change that adds the spans has none to read.
    monkeypatch.setattr(spans, "summary", lambda: {})
    assert _read(name, run) is None
    assert _read(name, _Run(None)) is None


def test_device_trace_metrics_and_the_capture_counter(monkeypatch):
    run = _Run(Traced(reduced={"busy_s": 1.75, "kernels": 175000},
                      steps=100))
    assert _read("fleet.card_ms_per_replay", run) == pytest.approx(17.5)
    assert _read("fleet.kernels_per_replay", run) == 1750
    assert _read("fleet.card_ms_per_replay", _Run(None)) is None
    monkeypatch.setattr(spans, "counter",
                        {"device.capture_ms": 2500.0}.get)
    assert _read("setup.device_capture_s", run) == pytest.approx(2.5)
    monkeypatch.setattr(spans, "counter", {}.get)
    assert _read("setup.device_capture_s", run) is None


class _CpuSegment:
    """The traced segment's profiler session, on the CPU."""

    def __init__(self):
        self.prof = None
        self.starts = 0

    def start(self):
        self.starts += 1
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def reduce(self):
        return {"busy_s": 0.0, "window_s": 1.0, "kernels": 0, "k1_s": 0.0,
                "k1_launches": 0, "device_ops": [], "idle_gaps": []}


def test_traced_run_holds_the_spans_of_exactly_one_segment():
    from hyperopt_tpu_torch.obs import trace

    _, cell = _tiny_cell()
    trace.span_clear()
    state = fleet_driver.setup(cell)
    run = harness.Run(cell)
    run.window = fleet_driver.window(state, 0.2, 9)
    assert spans.summary() == {}
    seg = _CpuSegment()
    run.traced = fleet_driver.profile(state, seg)
    got = spans.summary()
    assert seg.starts == 1 and run.traced.steps == TINY_TRAFFIC["sync_stride"]
    for name in ("fleet.segment", "fleet.run", "fleet.fetch", "fleet.land"):
        assert got[name]["count"] == 1, name
    for name, span in SPAN_METRICS.items():
        assert _read(name, run) == pytest.approx(
            got[span]["total_ns"] * 1e-6 / run.traced.steps)
    # K1's bound: every lane's 10 TPE steps of the segment.
    assert run.traced.k1_bound_s > 0
