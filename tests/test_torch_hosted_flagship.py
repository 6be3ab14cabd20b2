"""Resumed hosted studies on the flagship space against the benchmark's plain
reference, and the spans of the resume's host path, on the CPU (the
card's half: ``tests_torch_cuda/test_torch_cuda_hosted_graph.py``).

* Two studies resumed from one seeded history of 60 finished trials on
  ``portbench/spaces/flagship.py`` at ``n_dims`` 10 (13 parameters:
  uniform, log, lattice, normal and choice columns and a conditional
  branch), each a fresh ``Trials`` and ``fmin`` with ``tpe.suggest`` at 64
  candidates to 64 trials: histories 60-63, the top quarter of bucket 64,
  so every proposal takes the near-edge branch (the next bucket's kernel
  built ahead, the ring pad-copied to 128 rows).  Every proposal is what
  the float64 reference (``portbench/reference/``) scores best, within
  1e-3 nats, from the history before it and the seed ``fmin`` handed it;
  every row lies in its prior's support, carries the active set its
  branch gives, and its loss is the objective's, exactly.
* While a profiler records, ``trials.parse`` fires once a proposal inside
  ``tpe.history``, over the 60 resumed rows on a study's first proposal
  and over one row after that (the counter ``trials.rows_parsed``), and
  ``history.rebuild`` fires once a study; while none records, the store
  gets no span.
* The studies propose the same bits with the profiler on and off.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import history, tpe
from hyperopt_tpu_torch.obs import metrics, trace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import check, program  # noqa: E402
from portbench.reference import space as rspace  # noqa: E402
from portbench.reference import tpe as rtpe  # noqa: E402
from portbench.spaces import flagship  # noqa: E402

N_DIMS, N_HISTORY, MORE, N_CAND = 10, 60, 4, 64
STUDY_SEEDS = (2 ** 31 + 91, 5)
TPE = dict(gamma=0.25, n_startup_jobs=20, prior_weight=1.0,
           linear_forgetting=25, split="sqrt", cat_prior="sqrt",
           comp_sampler="icdf")
PS = rspace.params(flagship.build(rspace.PLAIN_HP, N_DIMS))
LABELS = flagship.objective_labels(N_DIMS)


def _rows_parsed():
    return metrics.registry().snapshot()["counters"].get(
        "trials.rows_parsed", 0.0)


def _objective(cfg):
    return flagship.objective({lab: float(cfg[lab]) for lab in LABELS})


def _seeded_docs():
    rng = np.random.default_rng([2 ** 31 + 3, 0])
    vals, live = rspace.sample(PS, N_HISTORY, rng)
    loss = check.objective(flagship.objective, LABELS, vals) \
        + rng.normal(0.0, 0.1, N_HISTORY)
    return program.history_docs(PS, vals, live, loss, range(N_HISTORY))


def _studies(profiled):
    """Both resumed studies: ``([(trials, [(tid, seed, rows parsed)],
    ring capacity)], span summary, raw spans)``."""
    space = flagship.build(ht.hp, N_DIMS)
    docs = _seeded_docs()
    trace.span_clear()
    out = []

    def run():
        for study_seed in STUDY_SEEDS:
            log = []

            def algo(new_ids, domain, trials, seed):
                before = _rows_parsed()
                got = tpe.suggest(new_ids, domain, trials, seed,
                                  n_EI_candidates=N_CAND, **TPE)
                log.append((int(new_ids[0]), int(seed),
                            _rows_parsed() - before))
                return got

            trials = program.trials_with(docs)
            ht.fmin(_objective, space, algo=algo,
                    max_evals=N_HISTORY + MORE, trials=trials,
                    rstate=np.random.default_rng(study_seed), device="cpu",
                    show_progressbar=False, verbose=False)
            tpe.wait_prewarm()
            caps = [st.cap for st in history._states(trials).values()]
            out.append((trials, log, caps))

    if profiled:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            run()
        finally:
            prof.stop()
    else:
        run()
    got = out, trace.span_summary(), trace.recent_spans()
    trace.span_clear()
    return got


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {profiled: _studies(profiled) for profiled in (False, True)}
    finally:
        torch.set_num_threads(n)


def test_every_proposal_is_the_references_best(runs):
    settings = rtpe.Settings(TPE, N_CAND)
    steps = 0
    for trials, log, caps in runs[False][0]:
        rows = program.plain_rows(PS, trials.trials)
        assert len(rows["tids"]) == N_HISTORY + MORE and rows["ok"].all()
        new = slice(N_HISTORY, None)
        vals = {lab: v[new] for lab, v in rows["vals"].items()}
        live = {lab: v[new] for lab, v in rows["active"].items()}
        assert check.support_violations(PS, vals, live) == 0
        assert check.active_mismatch(PS, vals, live) == 0
        assert check.loss_rel_err(flagship.objective, LABELS, vals,
                                  rows["raw_loss"][new]) == 0.0
        assert [tid for tid, _, _ in log] == list(range(N_HISTORY,
                                                        N_HISTORY + MORE))
        for tid, seed, _ in log:
            k = int(np.searchsorted(rows["tids"], tid))
            assert check.is_tpe_step(rows, k, settings)
            gap, at = check.step_gap(PS, settings,
                                     *check.sampled_step(rows, k, seed),
                                     "cpu")
            assert gap < 1e-3, (tid, gap, at)
            steps += 1
        # The near-edge branch pad-copied the ring to the next bucket.
        assert caps == [2 * tpe._bucket(N_HISTORY)]
    assert steps == len(STUDY_SEEDS) * MORE


def test_parse_and_rebuild_spans_of_each_study(runs):
    studies, summary, raw = runs[True]
    for _, log, _ in studies:
        assert [parsed for _, _, parsed in log] == [N_HISTORY] + [1] * (
            MORE - 1)
    n = len(STUDY_SEEDS) * MORE
    assert summary["tpe.suggest"]["count"] == n
    assert summary["trials.parse"]["count"] == n
    assert summary["trials.parse"]["parent"] == "tpe.history"
    assert summary["history.rebuild"]["count"] == len(STUDY_SEEDS)
    assert summary["history.rebuild"]["parent"] == "tpe.feed"
    by_id = {s["id"]: s for s in raw}
    for s in raw:
        if s["name"] in ("trials.parse", "history.rebuild"):
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
            assert s["request"] == parent["request"]


def test_no_span_while_nothing_records(runs):
    _, summary, raw = runs[False]
    assert summary == {} and raw == []


def test_studies_propose_the_same_bits_with_the_profiler_on(runs):
    def proposed(studies):
        return [[(d["tid"], d["misc"]["vals"], d["result"]["loss"])
                 for d in trials.trials] for trials, _, _ in studies]

    assert proposed(runs[False][0]) == proposed(runs[True][0])
