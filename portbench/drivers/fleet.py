"""Fleet studies: one space searched over many seeds at once on one card.

Each run is one call of the program's ``fleet.fmin_fleet``: ``n_lanes``
studies of ``max_evals`` trials each, from empty histories, on one
captured step of all lanes, with the configuration's objective on the
card (its space module's ``device_objective``, inside the capture), the
configuration's TPE settings and one fresh ``Trials`` per lane.  Every
``sync_stride`` trials the fleet fetches all lanes once and lands each
lane's rows into its own ``Trials``.  Each run's seed is drawn from the
cell's seed; lane ``j`` of a run with seed ``s`` draws its per-trial
seeds in order from ``numpy.random.default_rng(s + j).integers(2**31 -
1)``, the rule the program states, which the check recomputes here.
Runs follow one another until the window has lasted ``--seconds``; the
window ends with the run that is running then.

Set-up makes ``warm_runs`` whole runs; the first captures the step of all
lanes.  The captured step is cached under the objective's identity, so
one objective function serves the whole process.

The traced segment is one steady-state segment: the last ``sync_stride``
replays of one run, their fetch and the landing of every lane.  The last
lane's ``Trials`` starts the profiler once it has landed the rows before
that segment (the other lanes have landed theirs by then), and the
profiler stops when the run returns: a few milliseconds of the run's own
host work on its results after the last landing lie inside the segment.

Traffic parameters (``traffic/<mix>.json``): ``n_lanes``, ``max_evals``,
``sync_stride``, ``warm_runs``, ``check_steps``.
"""

from __future__ import annotations

import time

import numpy as np

from hyperopt_tpu_torch import fleet as _fleet

from .. import check, program
from ..window import Traced, Window


def lane_seeds(seed, n):
    """The per-trial seeds of the lane whose seed is ``seed``: ``n``
    draws, one at a time, as the program's loop draws one per trial."""
    rng = np.random.default_rng(int(seed))
    return [int(rng.integers(2 ** 31 - 1)) for _ in range(n)]


class _SegmentStart(program.Trials):
    """The last lane's ``Trials`` in the traced run: it starts the
    profiler once it holds ``start_at`` landed trials."""

    def __init__(self, seg, start_at):
        self._seg = seg
        self._start_at = start_at
        self.started = False
        super().__init__()

    def refresh(self):
        super().refresh()
        if not self.started and len(self._dynamic_trials) >= self._start_at:
            self.started = True
            self._seg.start()


class State:
    def __init__(self, cell):
        self.cell = cell
        tr = cell.traffic
        self.n_lanes = int(tr["n_lanes"])
        self.max_evals = int(tr["max_evals"])
        self.stride = int(tr["sync_stride"])
        self.cs = program.compiled(program.build_space(cell.builder,
                                                       cell.n_dims))
        self.objective = cell.builder.device_objective
        self.kwargs = cell.program_tpe()
        self.runs = []

    def run(self, seed, trials_list=None):
        """One fleet run; returns ``(seed, [Trials per lane])``."""
        if trials_list is None:
            trials_list = [program.Trials() for _ in range(self.n_lanes)]
        _fleet.fmin_fleet(self.objective, self.cs, n_lanes=self.n_lanes,
                          max_evals=self.max_evals, seed=seed,
                          sync_stride=self.stride, trials_list=trials_list,
                          device=self.cell.device, **self.kwargs)
        return seed, trials_list


def setup(cell):
    state = State(cell)
    rng = np.random.default_rng([cell.seed_key, 2])
    for _ in range(int(cell.traffic["warm_runs"])):
        state.run(int(rng.integers(2 ** 31 - 1)))
    return state


def _landed(trials):
    """``(rows, rows with a finite loss)`` of a lane's ``Trials``."""
    docs = trials.trials
    good = sum(d["state"] == program.DONE
               and d["result"].get("status") == "ok"
               and np.isfinite(d["result"].get("loss", np.nan))
               for d in docs)
    return len(docs), int(good)


def window(state, seconds, seed_key):
    rng = np.random.default_rng([seed_key, 1])
    runs = []
    t0 = time.perf_counter()
    while not runs or time.perf_counter() - t0 < seconds:
        runs.append(state.run(int(rng.integers(2 ** 31 - 1))))
    elapsed = time.perf_counter() - t0
    state.runs = runs
    w = Window(elapsed_s=elapsed)
    for _, trials_list in runs:
        for trials in trials_list:
            n, good = _landed(trials)
            w.attempted += n
            w.trials += good
            w.failed += n - good
    return w


def check_window(state, w, rng):
    cell = state.cell
    ps = cell.ps
    readings = {}
    last = None
    for seed, trials_list in state.runs:
        last = (seed, [program.plain_rows(ps, t.trials) for t in trials_list])
        for rows in last[1]:
            check.rows_checks(readings, cell, rows)
    # The TPE steps of every lane of the window's last run; the sample
    # holds the last trial of the last lane.
    seed, lanes = last
    steps = []
    for j, rows in enumerate(lanes):
        seeds = lane_seeds(seed + j, len(rows["tids"]))
        steps += [(j, k, seeds[k]) for k in range(len(seeds))
                  if check.is_tpe_step(rows, k, cell.settings)]
    idx = check.pick(rng, len(steps), int(cell.traffic["check_steps"]),
                     keep=[len(steps) - 1])
    sample = [check.sampled_step(lanes[j], k, s)
              for j, k, s in (steps[i] for i in idx)]
    readings["ei_gap"] = check.widest_gap(ps, cell.settings, sample,
                                          cell.device)
    return readings


def profile(state, seg):
    cell = state.cell
    rng = np.random.default_rng([cell.seed_key, 3])
    n, start_at = state.max_evals, state.max_evals - state.stride
    last = _SegmentStart(seg, start_at)
    trials_list = [program.Trials() for _ in range(state.n_lanes - 1)]
    trials_list.append(last)
    try:
        state.run(int(rng.integers(2 ** 31 - 1)), trials_list)
    finally:
        if last.started:
            seg.stop()
    if not last.started:
        raise RuntimeError("the traced run never reached its last segment")
    # One K1 launch a replay scores every lane: its least time is the sum
    # of the lanes' bounds, each from the lane's history before the step.
    hists = []
    for trials in trials_list:
        rows = program.plain_rows(cell.ps, trials.trials)
        hists += [check.prefix(rows, k) for k in range(start_at, n)
                  if check.is_tpe_step(rows, k, cell.settings)]
    return Traced(seg.reduce(), steps=n - start_at,
                  k1_bound_s=check.k1_bound_s(cell.ps, cell.settings, hists))


def close(state):
    state.runs = []
