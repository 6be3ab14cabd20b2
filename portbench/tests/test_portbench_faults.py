"""Whole runs on the CPU with the timed path broken underneath: each fault
a cell can have must turn ``correct`` false.  (One chip: no cell has an
exchange between chips to leave out; one proposal a call: no batch to
leave half of.)"""

import pytest

from portbench import program
from portbench.tests.tiny import run_tiny  # noqa: F401

Kernel = program.tpe._TpeKernel


def _patch_step(monkeypatch, edit):
    real = Kernel._suggest_lanes

    def step(self, *a, **k):
        row, act, best, ties = real(self, *a, **k)
        return edit(self, row), act, best, ties

    monkeypatch.setattr(Kernel, "_suggest_lanes", step)


def _first_density_pid(kern):
    g = next(g for g in kern.groups if not g.is_q)
    return int(g.pids[0])


@pytest.mark.parametrize("workload", ["branin2.studies200"])
def test_answer_altered_where_it_is_produced(monkeypatch, run_tiny,
                                             workload):
    def edit(kern, row):
        row = row.clone()
        row[:, _first_density_pid(kern)] += 0.75
        return row

    _patch_step(monkeypatch, edit)
    assert not run_tiny(workload)["correct"]


@pytest.mark.parametrize("workload", ["branin2.studies200"])
def test_step_returns_its_state_unchanged(monkeypatch, run_tiny, workload):
    # Every step hands back the first proposal it ever made.
    first = {}

    def edit(kern, row):
        key = (id(kern), row.shape[0])
        first.setdefault(key, row.clone())
        return first[key].clone()

    _patch_step(monkeypatch, edit)
    assert not run_tiny(workload)["correct"]
