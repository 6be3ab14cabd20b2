"""Health verdicts, the flight recorder, postmortem bundles and the cost
ledger of the PyTorch port, mirroring the host parts of
``tests/test_obs_health.py`` and ``tests/test_obs_flight.py``:

* ``health.assess`` on the same docs gives the JAX package's report
  (floats to 1e-12, the rest equal), with and without the TPE
  ``introspect`` hook, and ``tpe.introspect`` matches JAX's on the same
  trials (floats to 1e-12);
* the flight recorder arms, dumps, rate-limits, survives the
  ``flight.dump`` fault point and dumps on a crash of ``fmin``; a dump
  makes a bundle round trip whose sections hash equal to the payload they
  were written from;
* the cost ledger joins build rows, kernel-cache counts and dispatch rows.
"""

import json
import math
import os
import re
import signal
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.obs import health as health_j
from hyperopt_tpu_torch import convert, faults, tpe
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.exceptions import InjectedFault
from hyperopt_tpu_torch.obs import bundle, costs, flight, health
from hyperopt_tpu_torch.obs.events import EVENTS
from hyperopt_tpu_torch.obs.metrics import (MetricsRegistry,
                                            kernel_cache_stats, registry)

hp = ht.hp


@pytest.fixture(autouse=True)
def _clean_state():
    """Each test starts and ends with the recorder disarmed, the ledger
    empty and disarmed, no fault armed and the ring quiet."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)

    def reset():
        flight.uninstall()
        costs.disarm()
        costs.clear()
        faults.clear()
        EVENTS.disable()
        EVENTS.clear()

    reset()
    yield
    reset()
    torch.set_num_threads(n)


def _docs(losses, x=None):
    return [{"tid": i, "state": ht.JOB_STATE_DONE,
             "result": {"loss": float(l), "status": "ok"},
             "misc": {"vals": {"x": [float(i if x is None else x)]}}}
            for i, l in enumerate(losses)]


def _close(a, b, path="report"):
    """Equal structure; floats to 1e-12 relative (absolute near 0)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            assert math.isnan(b), path
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=1e-12), path
    else:
        assert a == b, path


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------


HISTORIES = {
    "improving": (_docs([10.0 / (i + 1) for i in range(30)]), "healthy"),
    "flat": (_docs([5.0 - 0.5 * i for i in range(8)] + [1.0] * 22),
             "stagnating"),
    "short": (_docs([3.0, 2.0, 1.0]), "healthy"),
    "duplicated": (_docs([1.0 / (i + 1) for i in range(10)], x=2.0),
                   "warn"),
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_history_verdicts_equal_jax(name):
    docs, verdict = HISTORIES[name]
    rep = health.assess(docs)
    assert rep["verdict"] == verdict
    _close(rep, health_j.assess(docs))


def _seeded(pkg, n, seed):
    """``n`` DONE trials of a 3-parameter space, through the package's own
    random search and a float32 objective."""
    space = {"x": pkg.hp.uniform("x", -3, 3),
             "y": pkg.hp.loguniform("y", -2, 1),
             "c": pkg.hp.choice("c", [0, 1])}

    def obj(p):
        return float(np.float32(p["x"]) ** 2 + np.float32(p["y"])
                     + np.float32(p["c"]))

    kw = {"device": "cpu"} if pkg is ht else {}
    t = pkg.Trials()
    pkg.fmin(obj, space, algo=pkg.rand.suggest, max_evals=n, trials=t,
             rstate=np.random.default_rng(seed), show_progressbar=False,
             **kw)
    return space, t


@pytest.mark.parametrize("n", [4, 24])
def test_introspect_and_assess_equal_jax(n):
    space_j, tj = _seeded(hj, n, seed=5)
    tt = convert.trials_from_jax_docs(tj)
    space_t = {"x": hp.uniform("x", -3, 3), "y": hp.loguniform("y", -2, 1),
               "c": hp.choice("c", [0, 1])}
    dom_t = Domain(lambda p: 0.0, space_t)
    dom_j = hj.base.Domain(lambda p: 0.0, space_j)
    info = tpe.introspect(dom_t, tt, gamma=0.3)
    _close(info, tpe_j.introspect(dom_j, tj, gamma=0.3))
    assert info["split_degenerate"] is (n == 4)
    rep = health.assess(tt.trials, domain=dom_t, trials=tt,
                        suggest_fn=partial(tpe.suggest, n_EI_candidates=8))
    _close(rep, health_j.assess(tj.trials, domain=dom_j, trials=tj,
                                suggest_fn=tpe_j.suggest))
    assert rep["verdict"] == ("warn" if n == 4 else "healthy")


def test_introspect_survives_errors_and_publish_gauges():
    def boom(domain, trials, seed=0):
        raise RuntimeError("surrogate exploded")

    def fake_suggest():
        pass

    fake_suggest.introspect = boom
    rep = health.assess(_docs([1.0]), domain=object(), trials=object(),
                        suggest_fn=fake_suggest)
    assert "error" in rep["introspection"]
    assert rep["checks"]["ei_collapse"] is None
    reg = MetricsRegistry(enabled=True)
    health.publish("e1", {"code": 3}, reg=reg)
    health.publish("e2", {"code": 0}, reg=reg)
    snap = reg.snapshot()
    assert snap["gauges"]["health.verdict.e1"] == 3
    assert snap["gauges"]["health.verdict.e2"] == 0
    assert snap["counters"]["health.assessments"] == 2


# ---------------------------------------------------------------------------
# flight recorder and bundles
# ---------------------------------------------------------------------------


def test_install_without_dir_is_noop():
    assert flight.install() is None
    assert not flight.armed()
    assert flight.dump("x", force=True) is None


def test_dump_round_trips_with_equal_state_hash(tmp_path):
    d = flight.install(str(tmp_path), sigterm=False)
    assert d == str(tmp_path) and flight.armed() and EVENTS.enabled
    registry().counter("obs_test.bundle").inc(3)
    EVENTS.emit("suggest", n=1)
    path = flight.dump("unit test!", force=True, extra={"k": 1})
    assert path is not None and os.path.isdir(path)
    assert re.fullmatch(rf"bundle-{os.getpid()}-\d{{3}}-unit-test-",
                        os.path.basename(path))
    payload = bundle.read_bundle(path)
    man = payload["manifest"]
    assert man["reason"] == "unit test!" and man["extra"] == {"k": 1}
    assert {"metrics", "device", "costs", "env"} <= set(man["sections"])
    assert any(e.get("type") == "flight_dump" for e in payload["events"])
    # A second bundle written from the payload read back is the same
    # bundle: every section hashes equal.
    again = bundle.read_bundle(bundle.write_payload(
        str(tmp_path / "copy"), payload))

    def h(doc):
        return bundle.state_hash(json.dumps(doc, sort_keys=True,
                                            default=str).encode())

    assert set(again) == set(payload)
    for name in payload:
        assert h(again[name]) == h(payload[name]), name
    assert payload["metrics"]["counters"]["obs_test.bundle"] >= 3
    flight.uninstall()
    assert flight.dump("after", force=True) is None


def test_env_section_redacts_tokens(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPEROPT_SERVICE_TOKEN", "s3kr1t")
    monkeypatch.setenv("TORCH_SHOW_CPP_STACKTRACES", "1")
    env = bundle.collect_payload("env")["env"]
    assert env["HYPEROPT_SERVICE_TOKEN"] == "<redacted>"
    assert env["TORCH_SHOW_CPP_STACKTRACES"] == "1"


def test_rate_limit_and_fault_point(tmp_path):
    flight.install(str(tmp_path), sigterm=False, min_interval_s=3600)
    counters = lambda: registry().snapshot()["counters"]  # noqa: E731
    sup = counters().get("flight.suppressed", 0)
    err = counters().get("flight.errors", 0)
    assert flight.dump("first") is not None
    assert flight.dump("second") is None
    assert counters()["flight.suppressed"] == sup + 1
    with faults.injected("flight.dump", prob=1.0):
        assert flight.dump("chaos", force=True) is None
    assert counters()["flight.errors"] == err + 1
    assert flight.dump("third", force=True) is not None


def test_sigterm_chains_previous_handler(tmp_path):
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        flight.install(str(tmp_path), sigterm=True)
        os.kill(os.getpid(), signal.SIGTERM)
        assert hits == [signal.SIGTERM]
        assert any(p.startswith("bundle-") for p in os.listdir(tmp_path))
        flight.uninstall()
        assert signal.getsignal(signal.SIGTERM) is not flight._on_sigterm
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_fmin_crash_dumps_a_bundle(tmp_path):
    flight.install(str(tmp_path), sigterm=False)
    costs.arm()
    with faults.injected("objective.call", prob=1.0, after=4):
        with pytest.raises(InjectedFault):
            ht.fmin(lambda p: p["x"] ** 2, {"x": hp.uniform("x", -1, 1)},
                    algo=partial(tpe.suggest, n_startup_jobs=2),
                    max_evals=8, rstate=7, show_progressbar=False,
                    device="cpu")
    (bdir,) = [p for p in os.listdir(tmp_path) if p.startswith("bundle-")]
    payload = bundle.read_bundle(str(tmp_path / bdir))
    assert payload["manifest"]["reason"] == "crash-fmin"
    assert "InjectedFault" in payload["manifest"]["extra"]["error"]
    types = {e.get("type") for e in payload["events"]}
    assert {"trial_start", "trial_end", "fault_injected"} <= types
    rows = payload["costs"]["entries"]
    assert [r["kernel"] for r in rows] == ["tpe"]


# ---------------------------------------------------------------------------
# cost ledger
# ---------------------------------------------------------------------------


def test_ledger_joins_builds_requests_and_dispatches():
    kernel_cache_stats(reset=True)      # the counts are process-wide
    costs.arm()
    space = {"x": hp.uniform("x", -2, 2), "y": hp.uniform("y", -2, 2)}
    t = ht.Trials()
    ht.fmin(lambda p: p["x"] ** 2 + p["y"] ** 2, space,
            algo=partial(tpe.suggest, n_startup_jobs=4), max_evals=10,
            trials=t, rstate=np.random.default_rng(1),
            show_progressbar=False, device="cpu")
    rep = costs.ledger_report()
    (row,) = rep["entries"]
    assert row["kernel"] == "tpe" and row["n_cap"] == 32 and row["m"] == 1
    assert row["compile_s"] > 0 and row["flops"] is None
    assert row["misses"] == 1 and row["requests"] == 6
    assert row["dispatches"] == 6
    assert row["ms_per_suggestion"] == pytest.approx(row["dispatch_ms_mean"])
    assert "suggest.dispatch_ms" in rep["live_ms"]
    costs.disarm()
    costs.observe_dispatch(("nothing",), 1.0)
    assert costs.record_compile("tpe", ("nothing",)) is None
