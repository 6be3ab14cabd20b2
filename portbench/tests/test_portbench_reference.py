"""The plain reference against the program on tiny CPU cases: the same
proposal, column for column, from the same history and seed."""

import numpy as np
import pytest

from portbench import check, program
from portbench.harness import HERE, load_file
from portbench.reference import space as rspace
from portbench.reference import tpe as rtpe


def _study(space_name, n_dims, n, seed):
    builder = load_file(HERE / "spaces" / f"{space_name}.py")
    ps = rspace.params(builder.build(rspace.PLAIN_HP, n_dims))
    rng = np.random.default_rng(seed)
    vals, live = rspace.sample(ps, n, rng)
    loss = check.objective(builder.objective,
                           builder.objective_labels(n_dims), vals) \
        + rng.normal(0, 0.1, n)
    trials = program.trials_with(program.history_docs(ps, vals, live, loss,
                                                      range(n)))
    space = program.build_space(builder, n_dims)
    domain = program.Domain(lambda cfg: 0.0, space)
    domain.cs.device = "cpu"
    return ps, space, domain, trials


@pytest.mark.parametrize("n_dims", [10, 25])
def test_reference_picks_the_programs_proposal(n_dims):
    ps, space, domain, trials = _study("flagship", n_dims, 120, 4)
    assert [p["label"] for p in ps] == program.labels(domain.cs)
    settings = rtpe.Settings(dict(gamma=0.25, linear_forgetting=25,
                                  prior_weight=1.0, n_startup_jobs=20), 256)
    rows = program.plain_rows(ps, trials.trials)
    for seed in (3, 2 ** 31 + 9, 77777):
        doc = program.tpe.suggest([120], domain, trials, seed,
                                  n_EI_candidates=256)[0]
        cols = rtpe.step(ps, check.prefix(rows, 120), seed, settings, "cpu")
        for lab, v in doc["misc"]["vals"].items():
            if not v:
                continue
            col = cols[lab]
            assert col.best - col.score(float(v[0])) < 1e-4, lab
            assert col.value == pytest.approx(v[0], rel=1e-5, abs=1e-6), lab


def test_reference_scores_a_value_off_the_support_as_never_drawn():
    ps, _, _, trials = _study("flagship", 10, 60, 1)
    settings = rtpe.Settings(dict(gamma=0.25, linear_forgetting=25,
                                  prior_weight=1.0, n_startup_jobs=20), 64)
    rows = program.plain_rows(ps, trials.trials)
    cols = rtpe.step(ps, check.prefix(rows, 60), 5, settings, "cpu")
    assert cols["u0"].score(-5.5) == -np.inf       # uniform(-5, 5)
    assert cols["q0"].score(3.0) == -np.inf        # quniform(0, 20, 2)
    assert cols["c0"].score(4.0) == -np.inf        # choice of 4
    assert np.isfinite(cols["u0"].score(-4.5))


def test_plain_space_walks_like_the_program():
    for n_dims in (50, 100):
        builder = load_file(HERE / "spaces" / "flagship.py")
        ps = rspace.params(builder.build(rspace.PLAIN_HP, n_dims))
        cs = program.compiled(program.build_space(builder, n_dims))
        assert [p["label"] for p in ps] == program.labels(cs)
        dens, lat, cat = rtpe.groups(ps)
        assert (len(dens), len(lat), len(cat)) == (
            3 * n_dims // 5 + 1, n_dims // 5 + 1, n_dims // 5 + 1)
