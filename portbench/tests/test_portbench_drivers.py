"""Each traffic driver, whole runs at a tiny size on the CPU."""

import pytest

from portbench import harness

from .tiny import run_tiny  # noqa: F401

CELLS = ("branin2.studies200",)


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_is_correct_and_reports_its_metrics(run_tiny, workload):
    result = run_tiny(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    want = {m["name"] for m in harness.cell_metrics(bench, workload,
                                                    "end_to_end")}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"
    for name, m in result["metrics"].items():
        assert m["value"] > 0, name


def test_hosted_window_keeps_every_proposal_latency():
    from portbench.drivers import hosted

    from .tiny import tiny_cell

    _, cell = tiny_cell("branin2.studies200")
    state = hosted.setup(cell)
    w = hosted.window(state, 0.5, 9)
    assert len(w.latencies_ms) == w.trials == sum(
        len(log) for _, log in state.studies)
