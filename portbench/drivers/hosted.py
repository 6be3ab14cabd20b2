"""Resumed hosted studies: the pattern of calling ``fmin`` again with a
larger ``max_evals``.

Each study is a fresh ``Trials`` holding the run's seeded history
(``n_history`` finished trials of the configuration's space, drawn from
the prior by the benchmark, loss = the objective plus N(0, 0.1) noise;
none for a study from empty), then ``fmin`` with ``algo=tpe.suggest`` and
the configuration's objective as a host function until ``max_evals =
n_history + study_more``: one closed-loop client, each proposal waiting
for the last trial.  Studies follow one another until
the window has lasted ``--seconds``; the window ends with the study that
is running then.  Traffic parameters (``traffic/<mix>.json``):
``study_more``, ``warm_studies``, ``profile_studies``, ``check_steps``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import check, program, trace
from ..reference import space as rspace
from ..window import Traced, Window


def seeded_history(cell, rng, n):
    """``n`` prior draws of the cell's space and their noisy losses."""
    vals, live = rspace.sample(cell.ps, n, rng)
    loss = check.objective(cell.builder.objective, cell.labels, vals) \
        + rng.normal(0.0, 0.1, n)
    return vals, live, loss


def host_objective(cell):
    """The configuration's objective (its space module's ``objective``) as
    the user's host function of a configuration."""
    fn, labels = cell.builder.objective, cell.labels

    def objective(cfg):
        return fn({lab: float(cfg[lab]) for lab in labels})

    return objective


class State:
    def __init__(self, cell):
        self.cell = cell
        self.space = program.build_space(cell.builder, cell.n_dims)
        self.n_history = int(cell.config["n_history"])
        self.max_evals = self.n_history + int(cell.traffic["study_more"])
        rng = np.random.default_rng([cell.seed_key, 0])
        vals, live, loss = seeded_history(cell, rng, self.n_history)
        self.docs = program.history_docs(cell.ps, vals, live, loss,
                                         range(self.n_history))
        self.log = []
        self.spans = False
        self.kwargs = cell.program_tpe()
        fn = host_objective(cell)

        def objective(cfg):
            with self._span("objective"):
                return fn(cfg)

        self.objective = objective

    def _span(self, name):
        return trace.span(name) if self.spans else contextlib.nullcontext()

    def algo(self, new_ids, domain, trials, seed):
        t0 = time.perf_counter()
        with self._span("suggest"):
            docs = program.tpe.suggest(new_ids, domain, trials, seed,
                                       **self.kwargs)
        ms = (time.perf_counter() - t0) * 1e3
        self.log.append((int(new_ids[0]), int(seed), ms))
        return docs

    def study(self, study_seed):
        """One resumed study; returns ``(trials, [(tid, seed, ms)])``."""
        n0 = len(self.log)
        with self._span("resume"):
            trials = program.trials_with(self.docs)
        program.fmin(self.objective, self.space, algo=self.algo,
                     max_evals=self.max_evals, trials=trials,
                     rstate=np.random.default_rng(study_seed),
                     device=self.cell.device, show_progressbar=False,
                     verbose=False)
        return trials, self.log[n0:]


def setup(cell):
    state = State(cell)
    rng = np.random.default_rng([cell.seed_key, 2])
    for _ in range(int(cell.traffic["warm_studies"])):
        state.study(int(rng.integers(2 ** 31 - 1)))
    return state


def window(state, seconds, seed_key):
    rng = np.random.default_rng([seed_key, 1])
    studies = []
    t0 = time.perf_counter()
    while not studies or time.perf_counter() - t0 < seconds:
        studies.append(state.study(int(rng.integers(2 ** 31 - 1))))
    elapsed = time.perf_counter() - t0
    state.studies = studies
    w = Window(elapsed_s=elapsed)
    for trials, log in studies:
        new = [d for d in trials.trials if d["tid"] >= state.n_history]
        w.attempted += len(new)
        good = sum(d["state"] == program.DONE
                   and d["result"].get("status") == "ok" for d in new)
        w.trials += good
        w.failed += len(new) - good
        w.latencies_ms += [ms for _, _, ms in log]
    return w


def check_window(state, w, rng):
    cell = state.cell
    ps, n0 = cell.ps, state.n_history
    readings = {}
    steps = []
    for trials, log in state.studies:
        rows = program.plain_rows(ps, trials.trials)
        check.rows_checks(readings, cell, rows, slice(n0, None))
        for tid, seed, _ in log:
            k = int(np.searchsorted(rows["tids"], tid))
            if check.is_tpe_step(rows, k, cell.settings):
                steps.append((rows, k, seed))
    # The sample holds the last proposal of the last study: the longest
    # history of the window.
    idx = check.pick(rng, len(steps), int(cell.traffic["check_steps"]),
                     keep=[len(steps) - 1])
    sample = [check.sampled_step(*steps[j]) for j in idx]
    readings["ei_gap"] = check.widest_gap(ps, cell.settings, sample,
                                          cell.device)
    return readings


def profile(state, seg):
    cell = state.cell
    rng = np.random.default_rng([cell.seed_key, 3])
    state.spans = True
    try:
        with seg.recording():
            studies = [state.study(int(rng.integers(2 ** 31 - 1)))
                       for _ in range(int(cell.traffic["profile_studies"]))]
    finally:
        state.spans = False
    hists, steps = [], 0
    for trials, log in studies:
        rows = program.plain_rows(cell.ps, trials.trials)
        steps += len(log)
        for tid, _, _ in log:
            k = int(np.searchsorted(rows["tids"], tid))
            if check.is_tpe_step(rows, k, cell.settings):
                hists.append(check.prefix(rows, k))
    # K1 runs in TPE steps only; a startup proposal launches no K1.
    return Traced(seg.reduce(), steps=steps,
                  k1_bound_s=check.k1_bound_s(cell.ps, cell.settings, hists))


def close(state):
    state.studies = []
