"""Shared helpers of the benchmark's own tests (run on the CPU:
``python -m pytest portbench/tests``).  Tests that need the card carry the
repository's ``cuda`` marker and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Sizes at which a whole run takes seconds on the CPU.
TINY_CONFIG = {"n_EI_candidates": 24}
TINY_TRAFFIC = {"study_more": 30, "check_steps": 400}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(workload, seed=2 ** 31 + 12345, overrides=None, bench=None):
    """The cell of ``BENCHMARK.json`` at the tiny sizes, on the CPU."""
    from portbench import harness

    bench = bench or harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, workload, seed, "cpu", overrides)
    cell.config = dict(cell.config, **TINY_CONFIG)
    cell.settings.n_cand = TINY_CONFIG["n_EI_candidates"]
    cell.traffic = dict(cell.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                         if k in cell.traffic})
    return bench, cell


@pytest.fixture
def run_tiny():
    """``run_tiny(workload, seconds=1, overrides=None)``: one whole run of
    the cell at the tiny sizes on the CPU; returns the result's dict."""
    from portbench import harness

    def run(workload, seconds=1.0, overrides=None):
        bench, cell = tiny_cell(workload, overrides=overrides)
        result, _ = harness.execute(bench, cell, seconds, False)
        return result

    return run
