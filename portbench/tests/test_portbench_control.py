"""The control: the program on its own lower-precision EI lowering
(``ei_precision="bf16"``, K2) must fail the cell's limits, where sound runs
pass them.  On the CPU at the tiny sizes (K2's plain twin), and on the card at each
cell's own size."""

import pytest

from portbench import calibrate, harness

from .tiny import TINY_CONFIG, TINY_TRAFFIC, card  # noqa: F401

SEEDS = (11, 2 ** 31 + 5, 40404)
CELLS = ("branin2.studies200",)


def _shrink(cell):
    cell.config = dict(cell.config, **TINY_CONFIG)
    cell.settings.n_cand = TINY_CONFIG["n_EI_candidates"]
    cell.traffic = dict(cell.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                         if k in cell.traffic})


def _limit(workload, name):
    return harness.load_json(harness.HERE / "checks" /
                             f"{workload}.json")["limits"][name]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_sound_runs_pass(workload):
    limit = _limit(workload, "ei_gap")
    sound = [r for _, r in calibrate.readings(
        workload, SEEDS, 0.5, device="cpu", tweak=_shrink)]
    control = [r for _, r in calibrate.readings(
        workload, SEEDS, 0.5, control="bf16", device="cpu", tweak=_shrink)]
    assert all(r["ei_gap"] <= limit for r in sound), sound
    assert all(r["ei_gap"] > limit for r in control), control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    limit = _limit(workload, "ei_gap")
    control = [r["ei_gap"] for _, r in calibrate.readings(
        workload, SEEDS, 2.0, control="bf16", device=card)]
    assert all(g > limit for g in control), control
