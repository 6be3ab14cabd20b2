"""The rest of ``fmin`` and of the TPE entry points in the PyTorch port,
against hyperopt_tpu where both write the same thing.

* ``trials_save_file="*.json"``: the plain-docs checkpoint round-trips and
  resumes; a file the JAX package wrote resumes in the port with the
  same docs (equality); numpy payloads are written as plain values, other
  payloads raise and leave no temporary file.
* ``fmin_pass_expr_memo_ctrl`` marks an objective as ``(expr, memo,
  ctrl)``.
* ``tpe.suggest_quantile``: its proposals are ``split="quantile"``'s, it
  runs in device mode (stride 1 equals the hosted run) and in the
  pipelined loop through its four halves.
* ``verbose=`` is accepted; the next bucket's kernel is built ahead off
  the caller's thread (``_prewarm_async``), and the run that crosses the
  bucket lands what it lands without it (equality).
"""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import tpe

CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def space(pkg):
    return {"x": pkg.hp.uniform("x", -5, 5),
            "c": pkg.hp.choice("c", [{"k": 0},
                                     {"k": 1, "w": pkg.hp.normal("w", 0, 1)}])}


def q(d):
    return (d["x"] - 1.0) ** 2 + d["c"].get("w", 0.0) ** 2


def _vals(t):
    return [(d["tid"], d["misc"]["vals"], d["result"]) for d in t]


def test_json_save_file_round_trips_and_resumes(tmp_path):
    path = str(tmp_path / "trials.json")
    ht.fmin(q, space(ht), algo=ht.rand.suggest, max_evals=10, rstate=0,
            trials_save_file=path, show_progressbar=False, device=CPU)
    with open(path) as f:
        payload = json.load(f)
    assert len(payload["docs"]) == 10
    first = payload["docs"]
    ht.fmin(q, space(ht), algo=ht.rand.suggest, max_evals=25, rstate=1,
            trials_save_file=path, show_progressbar=False, device=CPU,
            return_argmin=False)
    with open(path) as f:
        payload = json.load(f)
    assert len(payload["docs"]) == 25
    assert payload["docs"][:10] == first
    assert all(isinstance(d["result"]["loss"], float)
               for d in payload["docs"])
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_jax_written_json_resumes_in_the_port(tmp_path):
    path = str(tmp_path / "trials.json")
    hj.fmin(q, space(hj), algo=hj.rand.suggest, max_evals=12,
            rstate=np.random.default_rng(3), trials_save_file=path,
            show_progressbar=False)
    with open(path) as f:
        jax_docs = json.load(f)["docs"]
    # The port loads JAX's 12 docs, has nothing left to run at
    # max_evals=12, and writes them back as they were.
    ht.fmin(q, space(ht), algo=tpe.suggest, max_evals=12,
            rstate=np.random.default_rng(4), trials_save_file=path,
            show_progressbar=False, device=CPU)
    with open(path) as f:
        assert json.load(f)["docs"] == jax_docs
    # Past them, TPE continues from JAX's history.
    ht.fmin(q, space(ht), algo=partial(tpe.suggest, n_startup_jobs=5),
            max_evals=16, rstate=np.random.default_rng(4),
            trials_save_file=path, show_progressbar=False, device=CPU)
    with open(path) as f:
        docs = json.load(f)["docs"]
    assert len(docs) == 16 and docs[:12] == jax_docs


def test_json_save_file_payloads(tmp_path):
    path = str(tmp_path / "trials.json")

    def fn(d):
        return {"loss": d["x"] ** 2, "status": "ok",
                "np_scalar": np.float32(1.5), "np_int": np.int64(7),
                "np_arr": np.arange(3.0)}

    ht.fmin(fn, space(ht), algo=ht.rand.suggest, max_evals=4, rstate=0,
            trials_save_file=path, show_progressbar=False, device=CPU)
    with open(path) as f:
        doc = json.load(f)["docs"][0]
    assert (doc["result"]["np_scalar"], doc["result"]["np_int"],
            doc["result"]["np_arr"]) == (1.5, 7, [0.0, 1.0, 2.0])
    bad = str(tmp_path / "bad.json")
    with pytest.raises(TypeError, match="non-JSON-serializable"):
        ht.fmin(lambda d: {"loss": 0.0, "status": "ok", "obj": object()},
                space(ht), algo=ht.rand.suggest, max_evals=2, rstate=0,
                trials_save_file=bad, show_progressbar=False, device=CPU)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_fmin_pass_expr_memo_ctrl_decorator():
    seen = {}

    @ht.fmin_pass_expr_memo_ctrl
    def fn(expr, memo, ctrl):
        seen["ctrl"] = ctrl
        return {"loss": memo["x"] ** 2, "status": ht.STATUS_OK}

    assert fn.fmin_pass_expr_memo_ctrl is True
    t = ht.Trials()
    ht.fmin(fn, space(ht), algo=ht.rand.suggest, max_evals=3, rstate=0,
            trials=t, show_progressbar=False, device=CPU)
    assert len(t) == 3 and isinstance(seen["ctrl"], ht.Ctrl)
    assert all(d["result"]["status"] == ht.STATUS_OK for d in t)


def _host_q(d):
    e = np.float32(d["x"]) - np.float32(1.0)
    return float(e * e)


def _dev_q(p):
    e = p["x"] - 1.0
    return e * e


QUANT = dict(n_startup_jobs=6, n_EI_candidates=16)


def test_suggest_quantile_is_the_quantile_split():
    runs = []
    for algo in (partial(tpe.suggest_quantile, **QUANT),
                 partial(tpe.suggest, split="quantile", **QUANT)):
        t = ht.Trials()
        ht.fmin(_host_q, space(ht), algo=algo, max_evals=16, trials=t,
                rstate=np.random.default_rng(5), show_progressbar=False,
                device=CPU)
        runs.append(_vals(t))
    assert runs[0] == runs[1]
    assert tpe.suggest_quantile.dispatch is not tpe.suggest.dispatch
    for half in ("materialize", "start_transfer", "handle_ready",
                 "introspect"):
        assert getattr(tpe.suggest_quantile, half) is \
            getattr(tpe.suggest, half)


def test_suggest_quantile_in_device_mode_and_the_pipeline():
    algo = partial(tpe.suggest_quantile, verbose=False, **QUANT)
    a, b = ht.Trials(), ht.Trials()
    ht.fmin(_host_q, space(ht), algo=algo, max_evals=16, trials=a,
            rstate=np.random.default_rng(7), show_progressbar=False,
            device=CPU)
    ht.fmin(_dev_q, space(ht), algo=algo, max_evals=16, trials=b,
            rstate=np.random.default_rng(7), show_progressbar=False,
            device=CPU, mode="device", sync_stride=1)
    assert [d["misc"]["vals"] for d in a] == [d["misc"]["vals"] for d in b]
    # The pipeline drives its dispatch half (a spy counts the calls) and
    # lands the trials of the quantile split's pipelined run.
    calls = []
    orig = tpe.suggest_quantile.dispatch

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    tpe.suggest_quantile.dispatch = spy
    try:
        runs = []
        for algo in (tpe.suggest_quantile,
                     partial(tpe.suggest, split="quantile")):
            t = ht.Trials()
            ht.fmin(_host_q, space(ht), algo=partial(algo, **QUANT),
                    max_evals=16, trials=t, rstate=np.random.default_rng(8),
                    show_progressbar=False, device=CPU, overlap_depth=2)
            runs.append([d["misc"]["vals"] for d in t])
            assert len(t) == 16
    finally:
        tpe.suggest_quantile.dispatch = orig
    assert runs[0] == runs[1]
    assert len(calls) >= 16 - QUANT["n_startup_jobs"]


def test_prewarm_builds_the_next_bucket_and_changes_nothing(monkeypatch):
    """A hosted run across the 32 → 64 bucket: the 64 kernel is built by
    the prewarm thread once 24 rows are in, and the trials equal those of
    a run whose prewarm does nothing."""
    built = []
    init = tpe._TpeKernel.__init__

    def spy(self, cs, n_cap, *a, **k):
        built.append((n_cap, __import__("threading").current_thread().name))
        init(self, cs, n_cap, *a, **k)

    monkeypatch.setattr(tpe._TpeKernel, "__init__", spy)
    sp = space(ht)
    runs = []
    for prewarm in (True, False):
        ht.compile_space(sp).__dict__.pop("_tpe_kernels", None)
        built.clear()
        t = ht.Trials()
        with monkeypatch.context() as m:
            if not prewarm:
                m.setattr(tpe, "_prewarm_async", lambda kern, n=1: None)
            ht.fmin(_host_q, sp, algo=partial(tpe.suggest, **QUANT),
                    max_evals=36, trials=t, rstate=np.random.default_rng(9),
                    show_progressbar=False, device=CPU)
        tpe.wait_prewarm()
        where = dict(built)
        assert where[64] == ("tpe-prewarm-64" if prewarm else "MainThread")
        runs.append([d["misc"]["vals"] for d in t])
    assert runs[0] == runs[1]
    kern = tpe.get_kernel(ht.compile_space(sp), 32, 16, 25, device=CPU)
    tpe._prewarm_async(kern, n=4)
    tpe.wait_prewarm()
    assert tpe._prewarm_async(kern) is None          # once per kernel


def test_kernel_cache_builds_once_under_racing_threads(monkeypatch):
    """Threads (more than cores) and the prewarm thread asking for the same
    kernel at once: one build, every caller gets the same object."""
    import sys
    import threading

    built = []
    init = tpe._TpeKernel.__init__

    def spy(self, *a, **k):
        built.append(1)
        init(self, *a, **k)

    monkeypatch.setattr(tpe._TpeKernel, "__init__", spy)
    cs = ht.compile_space(space(ht))
    cs.__dict__.pop("_tpe_kernels", None)
    small = tpe.get_kernel(cs, 32, 8, 25, device=CPU)
    got, barrier = [], threading.Barrier(16)

    def ask():
        barrier.wait()
        got.append(tpe.get_kernel(cs, 64, 8, 25, device=CPU))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        tpe._prewarm_async(small)
        for t in threads:
            t.join(timeout=60)
        tpe.wait_prewarm()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 16 and all(k is got[0] for k in got)
    assert len(built) == 2          # the 32 kernel and one 64 kernel
