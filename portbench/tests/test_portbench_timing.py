"""The arithmetic of the end-to-end metrics and the K1 bound."""

import numpy as np
import pytest

from portbench import peaks, timing
from portbench.window import Window


@pytest.mark.parametrize("q", [50, 95])
def test_percentile_is_over_every_sample(q):
    rng = np.random.default_rng(1)
    xs = list(rng.exponential(10.0, 1001))
    assert timing.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_of_a_known_list():
    assert timing.percentile([4, 1, 3, 2], 50) == 2.5
    assert timing.percentile(list(range(101)), 95) == 95
    assert timing.percentile([], 50) is None


def test_rate_and_latencies_come_from_the_whole_window():
    from portbench.harness import load_file, HERE

    w = Window(elapsed_s=2.0, trials=300, latencies_ms=[1.0, 2.0, 9.0])

    class Run:
        window = w

    rate = load_file(HERE / "metrics" / "trials_per_s.py").read(Run)
    p50 = load_file(HERE / "metrics" / "suggest_p50_ms.py").read(Run)
    assert rate == 150.0 and p50 == 2.0


def test_since_process_start_is_positive_and_small():
    assert 0 < timing.since_process_start() < 3600


def test_k1_bound_hand_worked():
    # 31 columns, 10,000 candidates, 26 + 1,001 live components a column:
    # 31 * 1,027 = 31,837 components, 318,370,000 terms.
    comps = 31 * (26 + 1001)
    terms = 10_000 * comps
    s, by = peaks.k1_bound_s(terms, 31, comps, 10_000)
    exp_s = terms / (132 * 16 * 1.98e9)
    assert by == "exp"
    assert s == pytest.approx(exp_s)
    assert s * 1e3 == pytest.approx(0.07614, rel=1e-3)
    # Byte-bound when the terms are few: 1 component, 1 candidate.
    s2, by2 = peaks.k1_bound_s(1, 1, 1, 1)
    assert by2 == "bytes" and s2 == pytest.approx(4 * 5 / 3.35e12)


def test_k1_live_terms_follow_the_split():
    from portbench.reference import space as rspace
    from portbench.reference import tpe as rtpe

    ps = [dict(label="x", kind="normal", mu=0.0, sigma=1.0, conditions=()),
          dict(label="c", kind="choice", n_options=2, conditions=()),
          dict(label="y", kind="normal", mu=0.0, sigma=1.0,
               conditions=(("c", 1),))]
    n = 100
    rng = np.random.default_rng(0)
    vals, live = rspace.sample(ps, n, rng)
    h = {"vals": vals, "active": live,
         "loss": rng.normal(size=n).astype(np.float32),
         "ok": np.ones(n, bool)}
    settings = rtpe.Settings(dict(gamma=0.25, linear_forgetting=25,
                                  prior_weight=1.0, n_startup_jobs=20), 50)
    terms, cols, comps = rtpe.live_terms(ps, h, settings)
    below, above = rtpe.split(h["loss"], h["ok"], settings)
    assert below.sum() == 3            # ceil(0.25 * sqrt(100))
    n_y = int(live["y"].sum())
    assert cols == 2 and comps == (n + 2) + (n_y + 2)
    assert terms == 50 * comps
