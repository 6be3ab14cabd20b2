"""The PyTorch port's ``show`` (``hyperopt_tpu_torch/show.py``) against
``hyperopt_tpu.show``, on the same inputs.

* **Parity**: ``render_live`` on the dashboard snapshots of the JAX
  tests (partial stores, health and alerts, tenants, cohorts, routers,
  device, pool, autoscale and cost panels) and on a live port server's
  ``/metrics``; ``summarize_trace`` on a port ``fmin(trace_dir=)``
  directory (summary and events-only forms); ``merge_traces`` on the
  same flight bundles; ``show wal --json`` on WALs written by the port's
  and by JAX's ``ServiceServer``; ``show bundle``; ``show_lint`` on the
  JAX gate's report dicts; ``summarize`` on equivalent trials (in
  memory, ``--root`` over a file store, ``--pickle``).  The rendered text
  is equal byte for byte.  The one stated difference: ``live`` takes
  its token from ``--token`` only (JAX also reads it from the
  environment); frames are compared without ``prev`` or with a ``prev``
  that fixes the rate, since each package reads its own clock.
* **Mirrors** on the port of ``tests/test_service.py::TestShow``,
  ``tests/test_fleet.py``'s ``test_live_view_shows_cohort_occupancy`` and
  ``tests/test_obs_fleet.py``'s ``TestMergeTraces`` and
  ``TestLiveDashboard``.

Every server binds port 0 and is shut down by the test.
"""

import contextlib
import copy
import io
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import base, show
from hyperopt_tpu_torch.base import (JOB_STATE_DONE, JOB_STATE_ERROR,
                                     JOB_STATE_NEW, JOB_STATE_RUNNING,
                                     STATUS_OK)
from hyperopt_tpu_torch.obs import bundle as obs_bundle
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.obs.events import EVENTS
from hyperopt_tpu_torch.parallel.netstore import NetTrials, StoreServer
from hyperopt_tpu_torch.service.server import ServiceServer

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = metrics.metrics_enabled()
    metrics.set_enabled(True)
    yield
    metrics.set_enabled(was)
    torch.set_num_threads(n)


def jax_show():
    from hyperopt_tpu import show as show_j
    return show_j


def _text(fn, *a, **kw):
    buf = io.StringIO()
    out = fn(*a, out=buf, **kw)
    return buf.getvalue(), out


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return buf.getvalue(), rc


# ---------------------------------------------------------------------------
# render_live
# ---------------------------------------------------------------------------

_PAYLOAD = {
    "enabled": True,
    "counters": {"fmin.trials.done": 10, "faults.injected": 2,
                 "store.requeued": 1},
    "gauges": {"pipeline.occupancy": 3.0, "pipeline.eval_backlog": 2.0},
    "histograms": {
        "netstore.verb.reserve.s": {
            "count": 12, "sum": 0.1, "mean": 0.008, "min": 0.001,
            "max": 0.02, "p50": 0.008, "p90": 0.015, "p95": 0.018,
            "p99": 0.02},
    },
    "fleet": {
        "n_workers": 1,
        "workers": {"w:1:beef": {
            "age_s": 1.2, "counters": {"worker.trials": 4},
            "gauges": {"worker.consecutive_failures": 0},
            "histograms": {}}},
        "merged": {"counters": {"worker.trials": 4}, "gauges": {},
                   "histograms": {}},
    },
}

SNAPSHOTS = {
    "empty": {},
    "counters_only": {"counters": {"fmin.trials.done": 5,
                                   "faults.injected": 2},
                      "gauges": {}, "histograms": {}},
    "alerts_only": {"counters": {}, "gauges": {}, "histograms": {},
                    "alerts": [{"name": "suggest_p95", "firing": True,
                                "burn_fast": 4.0, "burn_slow": 2.2,
                                "value": 0.9, "target": 0.25}]},
    "health_and_alerts": {
        "counters": {"fmin.trials.done": 40}, "gauges": {},
        "histograms": {},
        "health": {"acme/e1": {"verdict": "stagnating", "n_done": 40,
                               "best_loss": 0.123456,
                               "checks": {"stagnating": True,
                                          "ei_collapse": False,
                                          "dup_high": True}},
                   "zeta/e2": {"verdict": "healthy", "n_done": 7,
                               "best_loss": None, "checks": {}}},
        "alerts": [{"name": "suggest_p95", "firing": False,
                    "burn_fast": None, "burn_slow": 0.5, "value": None,
                    "target": 0.25},
                   {"name": "wal_fsync_lag", "firing": True,
                    "burn_fast": 12.5, "burn_slow": 3.25, "value": 0.75,
                    "target": 0.1}]},
    "tenants": {"counters": {
        "netstore.tenant.acme.verb.reserve.calls": 12,
        "netstore.tenant.acme.quota.claims_rejected": 3,
        "netstore.tenant.bob.verb.insert_docs.calls": 5,
        "netstore.tenant.bob.quota.rate_rejected": 2},
        "gauges": {"netstore.tenant.acme.claims_held": 4},
        "histograms": {}, "fleet": {}},
    "cohorts": {"counters": {"fleet.dispatches": 7,
                             "fleet.suggestions": 35},
                "gauges": {"fleet.cohort_size_last": 5,
                           "fleet.cohort_tier_last": 8,
                           "fleet.padding_waste": 0.375}},
    "workers": _PAYLOAD,
    "router_down": {"router": {"version": 4, "n_shards": 1, "shards": {
        "s0": {"url": "http://x", "replica": None, "ok": False,
               "error": "URLError: refused"}}}},
    "router_two": {
        "counters": {"router.forwarded": 9, "router.failovers": 1,
                     "router.rebalances": 2},
        "histograms": {"router.shard.s0.s": {"count": 9, "p50": 0.002,
                                             "p95": 0.004, "p99": 0.009}},
        "router": {"version": 7, "n_shards": 2, "shards": {
            "s0": {"ok": True, "n_workers": 2, "verb_calls": 31},
            "s1": {"ok": False, "error": "timed out"}}}},
    "device": {
        "counters": {"device.segments": 4, "device.fetch_syncs": 4,
                     "device.trials_landed": 1000,
                     "device.segments.device.s8": 3,
                     "device.fetch_syncs.device.s8": 3,
                     "device.segments.device.none": 1,
                     "device.telemetry.nonfinite": 2,
                     "device.telemetry.argmax_ties": 5},
        "gauges": {"device.telemetry.best_loss": 0.0123,
                   "device.telemetry.ei_max": 3.5,
                   "device.telemetry.ei_mean": 1.25,
                   "device.telemetry.trials_per_sec": 512.0}},
    "pool_longpoll": {"counters": {
        "rpc.pool.hits": 30, "rpc.pool.misses": 10,
        "rpc.pool.stale_reconnects": 1, "rpc.pool.evicted": 2,
        "store.longpoll.parked": 6, "store.longpoll.woken": 5,
        "store.longpoll.timeouts": 1, "store.write.fenced": 1,
        "store.heartbeat.fenced": 2}},
    "autoscale": {"autoscale": {
        "running": True, "shed_level": 0.25, "calm": 1, "calm_ticks": 3,
        "min_shards": 1, "max_shards": 4,
        "decisions": [{"t": 1.7e9 + i, "action": "scale_up",
                       "burn": 2.5 + i, "shards": 2 + i % 2,
                       "ok": i % 3 != 0, "error": "refused",
                       "reason": f"burn {i}"} for i in range(8)]}},
    "autoscale_error": {"autoscale": {"error": "Unreachable"}},
    "cost": {"counters": {}, "costs": {
        "entries": [{"kernel": "tpe", "n_cap": 1024, "P": 50, "m": 1,
                     "compile_s": 0.25, "flops": 3.2e8,
                     "bytes_accessed": 6.5e7, "dispatches": 12,
                     "ms_per_suggestion": 4.5},
                    {"kernel": "gp", "n_cap": None, "P": None, "m": 8,
                     "compile_s": None, "flops": None,
                     "bytes_accessed": None, "dispatches": 0,
                     "ms_per_suggestion": None}],
        "kernel_cache": {"requests": 20, "misses": 2},
        "live_ms": {"suggest.dispatch_ms": {"count": 12, "mean": 4.25,
                                            "p95": None}}}},
    "cost_elsewhere": {"counters": {"cost.compiles": 3}},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_render_live_equals_jax(name):
    snap = SNAPSHOTS[name]
    got, (t_p, done_p) = _text(show.render_live, copy.deepcopy(snap))
    want, (t_j, done_j) = _text(jax_show().render_live, copy.deepcopy(snap))
    assert got == want
    assert done_p == done_j
    # a previous sample with no new trials fixes the rate at 0 whatever
    # each package's clock reads
    prev = (time.monotonic() - 2.0, done_p)
    got, _ = _text(show.render_live, copy.deepcopy(snap), prev=prev)
    want, _ = _text(jax_show().render_live, copy.deepcopy(snap), prev=prev)
    assert got == want and "0.00 trials/s" in got


def test_render_live_equals_jax_on_a_live_server(tmp_path):
    """A port ``ServiceServer``'s own ``/metrics`` (tenants, verb tails,
    the fleet section), rendered by both packages."""
    srv = ServiceServer(str(tmp_path / "wal"), token="t")
    srv.start()
    try:
        nt = NetTrials(srv.url, exp_key="e1", token="t", timeout=TIMEOUT)
        nt._insert_trial_docs(_docs([0, 1], "e1", [0.1, 0.2]))
        doc = nt.reserve("w0")
        nt.write_result(_complete(doc, 1.0), owner="w0")
        snap = show.fetch_metrics(srv.url, token="t")
        with pytest.raises(Exception, match="401|403|Forbidden|Unauth"):
            show.fetch_metrics(srv.url)
    finally:
        srv.shutdown()
    got, _ = _text(show.render_live, copy.deepcopy(snap))
    want, _ = _text(jax_show().render_live, copy.deepcopy(snap))
    assert got == want
    assert "reserve" in got and "write_result" in got


def test_live_takes_the_token_from_the_flag_only(tmp_path, monkeypatch,
                                                  capsys):
    """The stated difference: JAX's ``live`` also reads the environment's
    token; the port's takes ``--token`` only."""
    srv = StoreServer(str(tmp_path / "store"), token="s3kr1t")
    srv.start()
    try:
        monkeypatch.setenv("HYPEROPT_TPU_NETSTORE_TOKEN", "s3kr1t")
        assert show.main(["live", srv.url, "--once"]) == 1
        assert "fetch failed" in capsys.readouterr().out
        assert jax_show().main(["live", srv.url, "--once"]) == 0
        capsys.readouterr()
        assert show.main(["live", srv.url, "--once",
                          "--token", "s3kr1t"]) == 0
        assert "0 worker(s)" in capsys.readouterr().out
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# traces and bundles
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    """A port hosted ``fmin(trace_dir=)`` on the CPU."""
    import hyperopt_tpu_torch as ht

    d = tmp_path_factory.mktemp("show") / "trace"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ht.fmin(lambda p: (p["x"] - 1.0) ** 2,
                {"x": ht.hp.uniform("x", -5.5, 4.5)}, algo=ht.tpe.suggest,
                max_evals=6, trials=ht.Trials(),
                rstate=np.random.default_rng(0), show_progressbar=False,
                trace_dir=str(d), device="cpu")
    finally:
        torch.set_num_threads(n)
    return d


def test_summarize_trace_equals_jax(trace_dir, tmp_path):
    got, _ = _text(show.summarize_trace, str(trace_dir))
    want, _ = _text(jax_show().summarize_trace, str(trace_dir))
    assert got == want
    assert "coverage" in got and "evaluate" in got
    # the events-only form (no loop_trace.json)
    only = tmp_path / "events_only"
    only.mkdir()
    (only / "loop_events.jsonl").write_text(
        (trace_dir / "loop_events.jsonl").read_text())
    got, _ = _text(show.summarize_trace, str(only))
    want, _ = _text(jax_show().summarize_trace, str(only))
    assert got == want and "events:" in got
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert _text(show.summarize_trace, str(empty)) == \
        _text(jax_show().summarize_trace, str(empty))


def _bundles(tmp_path):
    """Two flight bundles of this process's event ring, the second after
    more events and with a clock-skewed meta header."""
    was = EVENTS.enabled
    EVENTS.clear()
    EVENTS.enable()
    try:
        for trial in range(3):
            EVENTS.emit("trial_start", trial=trial)
            EVENTS.emit("trial_end", trial=trial, loss=0.5 * trial)
        a = obs_bundle.write_bundle(str(tmp_path / "bundle-a"), "manual",
                                    extra={"trigger": "test"})
        EVENTS.emit("store_write", trial=1)
        b = obs_bundle.write_bundle(str(tmp_path / "bundle-b"), "slo")
    finally:
        EVENTS.clear()
        if not was:
            EVENTS.disable()
    path = Path(b) / "loop_events.jsonl"
    lines = path.read_text().splitlines()
    meta = json.loads(lines[0])
    meta.update(skew_s=1.5, role="worker")
    path.write_text("\n".join([json.dumps(meta)] + lines[1:]) + "\n")
    return [a, b]


def test_merge_traces_equals_jax_on_the_same_bundles(tmp_path):
    dirs = _bundles(tmp_path)
    out_p, out_j = tmp_path / "p.json", tmp_path / "j.json"
    got, doc_p = _text(show.merge_traces, dirs, out_path=str(out_p))
    want, doc_j = _text(jax_show().merge_traces, dirs, out_path=str(out_j))
    assert doc_p == doc_j
    assert json.loads(out_p.read_text()) == json.loads(out_j.read_text())
    assert got.replace(str(out_p), "OUT") == want.replace(str(out_j), "OUT")
    assert doc_p["otherData"]["n_lanes"] == 2
    # both bundles hold trials 0-2: each trial spans the two lanes
    assert doc_p["otherData"]["n_trial_flows"] == 3


def test_show_bundle_equals_jax(tmp_path):
    bdir = _bundles(tmp_path)[0]
    got, rc = _text(show.show_bundle, bdir)
    want, rc_j = _text(jax_show().show_bundle, bdir)
    assert (got, rc) == (want, rc_j) and rc == 0
    assert "ring:" in got and "trial_start:3" in got
    missing = str(tmp_path / "nope")
    os.makedirs(missing)
    assert _text(show.show_bundle, missing) == \
        _text(jax_show().show_bundle, missing)


def test_show_bundle_renders_the_cost_panel(tmp_path):
    bdir = _bundles(tmp_path)[0]
    with open(os.path.join(bdir, "costs.json"), "w") as f:
        json.dump(SNAPSHOTS["cost"]["costs"], f)
    got, _ = _text(show.show_bundle, bdir)
    want, _ = _text(jax_show().show_bundle, bdir)
    assert got == want and "cost:    2 ledger entr(ies)" in got


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------


def _docs(tids, exp_key, xs, pkg_base=base):
    out = []
    for tid, x in zip(tids, xs):
        d = pkg_base.new_trial_doc(tid, exp_key, None)
        d["misc"]["idxs"] = {"x": [tid]}
        d["misc"]["vals"] = {"x": [float(x)]}
        out.append(d)
    return out


def _complete(doc, loss):
    doc["state"] = JOB_STATE_DONE
    doc["result"] = {"status": STATUS_OK, "loss": float(loss)}
    return doc


def _drive_wal(server_cls, trials_cls, wal_dir, pkg_base, snapshot=False):
    srv = server_cls(wal_dir, token="t")
    srv.start()
    try:
        for ek in ("e1", "e2"):
            nt = trials_cls(srv.url, exp_key=ek, token="t", timeout=TIMEOUT)
            nt._insert_trial_docs(_docs([0, 1, 2], ek, [0.1, 0.2, 0.3],
                                        pkg_base))
            doc = nt.reserve("w0")
            nt.write_result(_complete(doc, 1.0), owner="w0")
            if snapshot and ek == "e1":
                srv.snapshot()
    finally:
        srv.shutdown()


def _wal_case(tmp_path, which, snapshot):
    wal_dir = str(tmp_path / f"wal-{which}-{snapshot}")
    if which == "port":
        _drive_wal(ServiceServer, NetTrials, wal_dir, base, snapshot)
    else:
        from hyperopt_tpu import base as base_j
        from hyperopt_tpu.parallel.netstore import NetTrials as NetTrialsJ
        from hyperopt_tpu.service.server import ServiceServer as ServerJ
        _drive_wal(ServerJ, NetTrialsJ, wal_dir, base_j, snapshot)
    return wal_dir


@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("snapshot", [False, True])
def test_show_wal_json_equals_jax(tmp_path, which, snapshot):
    wal_dir = _wal_case(tmp_path, which, snapshot)
    got, rc = _text(show.show_wal, wal_dir, as_json=True)
    want, rc_j = _text(jax_show().show_wal, wal_dir, as_json=True)
    assert rc == rc_j == 0
    info = json.loads(got)
    assert info == json.loads(want)
    assert info["per_verb"]["write_result"] == 2 - snapshot
    if snapshot:
        assert info["snapshot"]["stores"] == 1
    else:
        # without a snapshot the text form holds no clock either
        assert _text(show.show_wal, wal_dir) == \
            _text(jax_show().show_wal, wal_dir)


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------


def _report(**over):
    out = {"root": str(ROOT), "baseline": "baseline.json",
           "baseline_errors": [], "counts": {}, "new": [],
           "baselined": [], "stale": []}
    out.update(over)
    return out


_FINDING = {"rule": "LK002", "file": "hyperopt_tpu_torch/x.py", "line": 7,
            "symbol": "put", "message": "unlocked write"}
_OLD = {"rule": "AH001", "file": "chip_b.py", "line": 1, "symbol": "chip_b",
        "message": "no guard"}
LINT_REPORTS = {
    "new_and_baselined": _report(counts={"LK002": 1, "AH001": 1},
                                 new=[_FINDING], baselined=[_OLD]),
    "clean": _report(),
    "stale": _report(stale=[{"rule": "CP001",
                             "file": "hyperopt_tpu_torch/y.py",
                             "symbol": "f", "note": "fixed"}]),
    "baseline_errors": _report(baseline_errors=["entry 0: empty note"]),
}


@pytest.mark.parametrize("name", sorted(LINT_REPORTS))
def test_show_lint_equals_jax(name):
    got = _text(show.show_lint, LINT_REPORTS[name])
    want = _text(jax_show().show_lint, LINT_REPORTS[name])
    assert got == want
    assert got[1] == {"new_and_baselined": 1, "clean": 0, "stale": 1,
                      "baseline_errors": 2}[name]


def test_show_lint_reads_a_saved_report(tmp_path, capsys):
    path = tmp_path / "report.json"
    path.write_text(json.dumps(LINT_REPORTS["new_and_baselined"]))
    assert show.main(["lint", str(path)]) == 1
    out = capsys.readouterr().out
    assert "[NEW ] hyperopt_tpu_torch/x.py:7 [put] unlocked write" in out
    assert "[base] chip_b.py:1 [chip_b] no guard" in out


# ---------------------------------------------------------------------------
# summarize
# ---------------------------------------------------------------------------


def _summary_docs(pkg_base):
    docs = _docs(range(6), "e", [0.5, -1.0, 2.0, 0.25, 1.5, 3.0], pkg_base)
    states = [JOB_STATE_DONE, JOB_STATE_DONE, JOB_STATE_ERROR,
              JOB_STATE_RUNNING, JOB_STATE_NEW, JOB_STATE_DONE]
    for i, (d, st) in enumerate(zip(docs, states)):
        d["state"] = st
        if st == JOB_STATE_DONE:
            d["result"] = {"status": STATUS_OK, "loss": 0.1 * (3 - i)}
        elif st == JOB_STATE_ERROR:
            d["result"] = {"status": "fail"}
        if st in (JOB_STATE_DONE, JOB_STATE_RUNNING):
            d["owner"] = f"host{i % 2}:123"
    return docs


def _trials_pair():
    from hyperopt_tpu import base as base_j
    tp = base.trials_from_docs(_summary_docs(base), exp_key="e")
    tj = base_j.trials_from_docs(_summary_docs(base_j), exp_key="e")
    tp.attachments["note"] = b"x"
    tj.attachments["note"] = b"x"
    return tp, tj


def test_summarize_equals_jax():
    tp, tj = _trials_pair()
    got, _ = _text(show.summarize, tp)
    want, _ = _text(jax_show().summarize, tj)
    assert got == want
    assert "best loss: 0.1 (tid 5)" not in got and "trials: 6" in got
    assert "attachments: 1" in got
    from hyperopt_tpu import base as base_j
    empty_p, _ = _text(show.summarize, base.Trials())
    empty_j, _ = _text(jax_show().summarize, base_j.Trials())
    assert empty_p == empty_j and "no successful trials" in empty_p


def test_summarize_pickle_equals_jax(tmp_path):
    tp, tj = _trials_pair()
    pp, pj = tmp_path / "p.pkl", tmp_path / "j.pkl"
    pp.write_bytes(pickle.dumps(tp))
    pj.write_bytes(pickle.dumps(tj))
    got, rc = _stdout(show.main, ["--pickle", str(pp)])
    want, rc_j = _stdout(jax_show().main, ["--pickle", str(pj)])
    assert (got, rc) == (want, rc_j) and rc == 0
    png = tmp_path / "h.png"
    out, rc = _stdout(show.main, ["--pickle", str(pp), "--plot", str(png)])
    assert rc == 0 and png.stat().st_size > 0 and f"wrote {png}" in out


def test_summarize_file_store_equals_jax(tmp_path):
    from hyperopt_tpu_torch.parallel.filestore import FileTrials

    root = str(tmp_path / "exp")
    ft = FileTrials(root, exp_key="e")
    ft._insert_trial_docs(_summary_docs(base))
    got, rc = _stdout(show.main, ["--root", root, "--exp-key", "e"])
    want, rc_j = _stdout(jax_show().main, ["--root", root, "--exp-key", "e"])
    assert (got, rc) == (want, rc_j) and rc == 0
    assert "trials: 6" in got


def test_pickle_of_a_run_loads_without_cuda(tmp_path):
    """A pickled port ``Trials`` after an ``fmin`` holds no tensors: a
    process with no CUDA device (and torch's CUDA hidden) summarizes it
    with ``--pickle``."""
    import hyperopt_tpu_torch as ht

    t = ht.Trials()
    ht.fmin(lambda p: p["x"] ** 2, {"x": ht.hp.uniform("x", -3.25, 2.75)},
            algo=ht.tpe.suggest, max_evals=4, trials=t,
            rstate=np.random.default_rng(1), show_progressbar=False,
            device="cpu")
    path = tmp_path / "t.pkl"
    path.write_bytes(pickle.dumps(t))
    blob = path.read_bytes()
    assert b"torch._utils" not in blob and b"_rebuild_tensor" not in blob
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "hyperopt_tpu_torch.show", "--pickle",
         str(path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _text(show.summarize, t)[0]


# ---------------------------------------------------------------------------
# mirrors
# ---------------------------------------------------------------------------


class TestShow:
    """``tests/test_service.py::TestShow`` on the port."""

    def test_show_wal_subcommand(self, tmp_path, capsys):
        wal_dir = str(tmp_path / "wal")
        srv = ServiceServer(wal_dir, token="t")
        srv.start()
        try:
            nt = NetTrials(srv.url, exp_key="e1", token="t",
                           timeout=TIMEOUT)
            nt._insert_trial_docs(_docs([0, 1], "e1", [0.1, 0.2]))
            doc = nt.reserve("w0")
            nt.write_result(_complete(doc, 1.0), owner="w0")
        finally:
            srv.shutdown()
        assert show.main(["wal", wal_dir]) == 0
        out = capsys.readouterr().out
        assert "wal dir:" in out
        assert "insert_docs" in out
        assert "write_result" in out
        assert show.main(["wal", wal_dir, "--json"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["per_verb"]["write_result"] == 1

    def test_live_dashboard_has_tenant_section(self):
        buf = io.StringIO()
        show.render_live(SNAPSHOTS["tenants"], out=buf)
        out = buf.getvalue()
        assert "acme" in out and "bob" in out
        assert "tenant" in out


def test_live_view_shows_cohort_occupancy():
    """``tests/test_fleet.py::TestServiceGate::
    test_live_view_shows_cohort_occupancy`` on the port."""
    buf = io.StringIO()
    show.render_live(SNAPSHOTS["cohorts"], out=buf)
    text = buf.getvalue()
    assert "cohorts: last 5/8 lanes" in text
    assert "padding 38%" in text
    assert "dispatches 7" in text and "suggestions 35" in text
    buf2 = io.StringIO()
    show.render_live({"counters": {}, "gauges": {}}, out=buf2)
    assert "cohorts:" not in buf2.getvalue()


def _write_events_file(path, meta, events):
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", **meta}) + "\n")
        for e in events:
            f.write(json.dumps(e) + "\n")


class TestMergeTraces:
    """``tests/test_obs_fleet.py::TestMergeTraces`` on the port."""

    def test_skew_normalization_regression(self, tmp_path):
        server = tmp_path / "server.jsonl"
        worker = tmp_path / "worker.jsonl"
        _write_events_file(server, {"pid": 1, "wall0": 1000.0,
                                    "mono0": 0.0, "skew_s": 0.0},
                           [{"type": "store_claim", "trial": 7,
                             "t_mono": 5.0, "t_wall": 1005.0,
                             "thread": "MainThread"}])
        _write_events_file(worker, {"pid": 2, "wall0": 1055.0,
                                    "mono0": 100.0, "skew_s": 50.0},
                           [{"type": "trial_start", "trial": 7,
                             "t_mono": 105.0, "t_wall": 1060.0,
                             "thread": "MainThread"}])
        doc = show.merge_traces([str(server), str(worker)],
                                out=io.StringIO())
        evs = [e for e in doc["traceEvents"]
               if e.get("cat", "").startswith("hyperopt_tpu")]
        by_pid = {e["pid"]: e["ts"] for e in evs}
        assert by_pid[1] == pytest.approx(1005.0 * 1e6, abs=1e3)
        assert by_pid[2] == pytest.approx(1010.0 * 1e6, abs=1e3)
        assert abs(by_pid[2] - by_pid[1]) < 10.0 * 1e6

    def test_cross_process_flow_arrows(self, tmp_path):
        a = tmp_path / "a.jsonl"
        b = tmp_path / "b.jsonl"
        meta = {"wall0": 0.0, "mono0": 0.0, "skew_s": 0.0}
        _write_events_file(a, dict(meta, pid=10, role="server"), [
            {"type": "trial_queued", "trial": 1, "t_mono": 1.0,
             "t_wall": 1.0, "thread": "MainThread"},
            {"type": "store_write", "trial": 1, "t_mono": 4.0,
             "t_wall": 4.0, "thread": "MainThread"},
            {"type": "trial_queued", "trial": 2, "t_mono": 1.5,
             "t_wall": 1.5, "thread": "MainThread"},
        ])
        _write_events_file(b, dict(meta, pid=11, worker_id="w:1:beef"), [
            {"type": "trial_start", "trial": 1, "t_mono": 2.0,
             "t_wall": 2.0, "thread": "MainThread"},
            {"type": "trial_end", "trial": 1, "t_mono": 3.0,
             "t_wall": 3.0, "thread": "MainThread"},
        ])
        doc = show.merge_traces([str(a), str(b)], out=io.StringIO())
        assert doc["otherData"]["n_trial_flows"] == 1
        flows = [e for e in doc["traceEvents"]
                 if e.get("cat") == "trial_flow"]
        assert all(e["id"] == "1" for e in flows)
        phases = [e["ph"] for e in sorted(flows, key=lambda e: e["ts"])]
        assert phases[0] == "s" and phases[-1] == "f"
        assert {e["pid"] for e in flows} == {1, 2}
        names = [e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M"]
        assert any("server" in n for n in names)
        assert any("w:1:beef" in n for n in names)

    def test_anchorless_file_skipped_with_warning(self, tmp_path):
        good = tmp_path / "server.jsonl"
        bad = tmp_path / "worker.jsonl"
        _write_events_file(good, {"pid": 1, "wall0": 1000.0, "mono0": 0.0,
                                  "skew_s": 0.0},
                           [{"type": "trial_start", "trial": 1,
                             "t_mono": 5.0, "t_wall": 1005.0,
                             "thread": "MainThread"}])
        _write_events_file(bad, {"pid": 2, "skew_s": 0.0},
                           [{"type": "trial_start", "trial": 2,
                             "t_mono": 1.0, "t_wall": 1001.0,
                             "thread": "MainThread"}])
        buf = io.StringIO()
        doc = show.merge_traces([str(good), str(bad)], out=buf)
        evs = [e for e in doc["traceEvents"]
               if e.get("cat", "").startswith("hyperopt_tpu")]
        assert {e["pid"] for e in evs} == {1}
        assert doc["otherData"]["n_lanes"] == 1
        assert doc["otherData"]["merged_from"] == [str(good)]
        warning = buf.getvalue()
        assert "worker.jsonl" in warning
        assert "wall0" in warning and "skipping" in warning

    def test_merge_writes_loadable_artifact(self, tmp_path, capsys):
        a = tmp_path / "a.jsonl"
        _write_events_file(a, {"pid": 1, "wall0": 0.0, "mono0": 0.0,
                               "skew_s": 0.0},
                           [{"type": "suggest", "t_mono": 1.0,
                             "t_wall": 1.0, "thread": "MainThread",
                             "n": 4}])
        out_path = tmp_path / "merged.json"
        assert show.main(["trace", "--merge", str(a), "-o",
                          str(out_path)]) == 0
        assert f"wrote {out_path}" in capsys.readouterr().out
        with open(out_path) as f:
            doc = json.load(f)
        assert isinstance(doc["traceEvents"], list)
        assert doc["otherData"]["merged_from"] == [str(a)]


class TestLiveDashboard:
    """``tests/test_obs_fleet.py::TestLiveDashboard`` on the port."""

    def test_render_live_frame(self):
        buf = io.StringIO()
        sample = show.render_live(copy.deepcopy(_PAYLOAD), out=buf)
        text = buf.getvalue()
        assert "1 worker(s)" in text
        assert "reserve" in text and "p99ms" in text
        assert "w:1:beef" in text
        assert "faults injected 2" in text
        assert "occupancy 3.0" in text
        buf2 = io.StringIO()
        show.render_live(copy.deepcopy(_PAYLOAD), out=buf2,
                         prev=(sample[0] - 2.0, sample[1] - 4))
        assert "trials/s" in buf2.getvalue()

    def test_live_once_against_real_server(self, tmp_path):
        srv = StoreServer(str(tmp_path / "store"))
        srv.start()
        try:
            buf = io.StringIO()
            rc = show.live(srv.url, once=True, out=buf)
            assert rc == 0
            assert "0 worker(s)" in buf.getvalue()
        finally:
            srv.shutdown()

    def test_live_once_fetch_failure_is_rc_1(self):
        buf = io.StringIO()
        rc = show.live("http://127.0.0.1:9", once=True, out=buf)
        assert rc == 1
        assert "fetch failed" in buf.getvalue()
