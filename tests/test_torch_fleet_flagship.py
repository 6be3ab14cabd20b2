"""The fleet on the flagship space against the benchmark's plain reference,
and the spans of the fleet's host path, on the CPU (the card's half:
``tests_torch_cuda/test_torch_cuda_fleet.py``).

* ``fmin_fleet`` at 4 lanes of 40 trials, stride 10 and 64 candidates, on
  ``portbench/spaces/flagship.py`` at ``n_dims`` 10 (13 parameters:
  uniform, log, lattice, normal and choice columns and a conditional
  branch) with its float32 objective on the device
  (``portbench/spaces/flagship_dev.py``): every TPE step of every lane
  proposes what the float64 reference (``portbench/reference/``) scores
  best, within 1e-3 nats, from the lane's landed history and the trial
  seed the fleet's rule gives (lane ``j`` draws from ``default_rng(seed +
  j)``); every landed row lies in its prior's support, carries the active
  set its branch gives, and its loss is the float64 objective's to 1e-6.
* While a profiler records, each segment is one ``fleet.segment`` span
  holding one ``fleet.run``, one ``fleet.fetch`` and one ``fleet.land``;
  while none records, the store gets no span.
* The lanes land the same bits with the profiler on and off.
"""

import collections
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import fleet
from hyperopt_tpu_torch.obs import trace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import check, program  # noqa: E402
from portbench.reference import space as rspace  # noqa: E402
from portbench.reference import tpe as rtpe  # noqa: E402
from portbench.spaces import flagship_dev  # noqa: E402

N_DIMS, LANES, N, STRIDE, N_CAND = 10, 4, 40, 10, 64
SEED = 2 ** 31 + 77
TPE = dict(gamma=0.25, n_startup_jobs=20, prior_weight=1.0,
           linear_forgetting=25, split="sqrt", cat_prior="sqrt",
           comp_sampler="icdf")
CHILDREN = ("fleet.run", "fleet.fetch", "fleet.land")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fleet_run(profiled):
    """One fleet run; ``(lanes' Trials, span summary, raw spans)``."""
    space = flagship_dev.build(ht.hp, N_DIMS)
    trials = [ht.Trials() for _ in range(LANES)]
    trace.span_clear()

    def run():
        fleet.fmin_fleet(flagship_dev.device_objective, space,
                         n_lanes=LANES, max_evals=N, seed=SEED,
                         sync_stride=STRIDE, trials_list=trials,
                         n_EI_candidates=N_CAND, device="cpu", **TPE)

    if profiled:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            run()
        finally:
            prof.stop()
    else:
        run()
    out = trials, trace.span_summary(), trace.recent_spans()
    trace.span_clear()
    return out


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {profiled: _fleet_run(profiled) for profiled in (False, True)}
    finally:
        torch.set_num_threads(n)


def test_every_tpe_step_of_every_lane_matches_the_reference(runs):
    trials = runs[False][0]
    ps = rspace.params(flagship_dev.build(rspace.PLAIN_HP, N_DIMS))
    labels = flagship_dev.objective_labels(N_DIMS)
    settings = rtpe.Settings(TPE, N_CAND)
    steps = 0
    for j, lane in enumerate(trials):
        rows = program.plain_rows(ps, lane.trials)
        assert len(rows["tids"]) == N and rows["ok"].all()
        assert check.support_violations(ps, rows["vals"], rows["active"]) == 0
        assert check.active_mismatch(ps, rows["vals"], rows["active"]) == 0
        assert check.loss_rel_err(flagship_dev.objective, labels, rows["vals"],
                                  rows["raw_loss"]) < 1e-6
        rng = np.random.default_rng(SEED + j)
        seeds = [int(rng.integers(2 ** 31 - 1)) for _ in range(N)]
        for k in range(N):
            if not check.is_tpe_step(rows, k, settings):
                continue
            gap, at = check.step_gap(ps, settings,
                                     *check.sampled_step(rows, k, seeds[k]),
                                     "cpu")
            assert gap < 1e-3, (j, k, gap, at)
            steps += 1
    assert steps == LANES * (N - TPE["n_startup_jobs"])


def test_spans_one_per_segment_with_their_parents(runs):
    _, summary, raw = runs[True]
    n_seg = N // STRIDE
    for name in ("fleet.segment",) + CHILDREN:
        assert summary[name]["count"] == n_seg, name
    assert summary["fleet.segment"]["parent"] is None
    segs = {s["id"]: s for s in raw if s["name"] == "fleet.segment"}
    assert len(segs) == n_seg
    held = collections.Counter()
    for s in raw:
        if s["name"] not in CHILDREN:
            continue
        assert summary[s["name"]]["parent"] == "fleet.segment"
        seg = segs[s["parent"]]
        assert seg["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= seg["end_ns"]
        held[s["parent"], s["name"]] += 1
    assert held == {(sid, name): 1 for sid in segs for name in CHILDREN}


def test_no_span_while_nothing_records(runs):
    _, summary, raw = runs[False]
    assert summary == {} and raw == []


def test_lanes_land_the_same_bits_with_the_profiler_on(runs):
    def landed(trials):
        return [[(d["tid"], d["misc"]["vals"], d["result"]["loss"])
                 for d in t.trials] for t in trials]

    assert landed(runs[False][0]) == landed(runs[True][0])
