"""The network store on the card (the CPU half: ``tests/
test_torch_netstore.py``): a server-side suggest on CUDA equals the
in-process suggest bit for bit, a server thread and this thread suggest
on the card at once and each lands its serial rows, two threads that
reach an unbuilt kernel together build it once and both launch it, and
the launch counts lose no update when many threads launch at once."""

import threading
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import backends, base, rand, tpe
from hyperopt_tpu_torch.backends import contract
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.ops import ei_scores as ek
from hyperopt_tpu_torch.parallel.netstore import (NetTrials, StoreServer,
                                                  server_suggest)

SPACE = {"x": ht.hp.uniform("x", -5, 5), "lr": ht.hp.loguniform("lr", -6, 0),
         "q": ht.hp.quniform("q", 0, 20, 2),
         "c": ht.hp.choice("c", [0, 1, 2])}
HEADS = {"tpe_bf16_card": partial(tpe.suggest, ei_precision="bf16"),
         "tpe_mxu_card": partial(tpe.suggest, ei_impl="mxu")}


def _objective(cfg):
    return (cfg["x"] - 1.0) ** 2 + cfg["q"]


def _graphs():
    snap = registry().snapshot()["counters"]
    return {k: snap.get(f"tpe.graph.{k}", 0.0)
            for k in ("captures", "replays", "eager_steps")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    for name, fn in HEADS.items():
        backends.register_backend(name, fn, replace=True)
    srv = StoreServer(str(tmp_path_factory.mktemp("store")))
    srv.start()
    dom = ht.Domain(_objective, SPACE)
    dom.cs.device = None        # no device: CUDA, here and on the server
    history = rand.suggest(list(range(60)), dom, ht.Trials(), 3)
    rng = np.random.default_rng(0)
    for d in history:
        d["state"] = base.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    yield srv, dom, history
    srv.shutdown()
    with contract._REGISTRY_LOCK:
        for name in HEADS:
            contract._REGISTRY.pop(name, None)


def _client(srv, dom, history, ek_):
    nt = NetTrials(srv.url, exp_key=ek_, timeout=60.0)
    nt.save_domain(dom)
    nt.insert_trial_docs([dict(d, exp_key=ek_) for d in history])
    nt.refresh()
    local = base.trials_from_docs([dict(d, exp_key=ek_) for d in history],
                                  exp_key=ek_)
    return nt, local


@pytest.mark.cuda
@pytest.mark.parametrize("name,low", [("tpe", "f32"),
                                      ("tpe_bf16_card", "bf16"),
                                      ("tpe_mxu_card", "mxu")])
def test_server_suggest_on_cuda_equals_in_process(served, name, low):
    srv, dom, history = served
    nt, local = _client(srv, dom, history, f"eq-{name}")
    assert nt.load_domain().cs.device is None
    eager = []
    for seed in range(3):
        ek.reset_launches()
        g0 = _graphs()
        got = server_suggest([60], None, nt, seed, algo=name)
        g = {k: _graphs()[k] - g0[k] for k in g0}
        # The step runs the named lowering once: launched eagerly (the
        # server kernel's first step), or replayed from the hosted step
        # graph, which recorded it once while its capture's warm-up
        # launched it once.
        eager.append(1 - g["replays"])
        assert ek.ei_scores.recorded_by == {
            k: g["captures"] * (k == low) for k in ek.ei_scores.recorded_by}
        assert ek.ei_scores.launches_by == {
            k: (eager[-1] + g["captures"]) * (k == low)
            for k in ek.ei_scores.launches_by}
        assert g["eager_steps"] == 0
        want = contract.server_table()[name]([60], dom, local, seed)
        assert got == want
    # At most the first step on the kernel runs eagerly; the others replay.
    assert eager in ([1, 0, 0], [0, 0, 0]), eager


@pytest.mark.cuda
def test_server_thread_and_this_thread_suggest_at_once(served):
    srv, dom, history = served
    nt, local = _client(srv, dom, history, "concurrent")
    seeds = list(range(8))
    want_srv = [server_suggest([60], None, nt, s) for s in seeds]
    want_loc = [tpe.suggest([60], dom, local, s) for s in seeds]
    got_srv, errors = [], []
    barrier = threading.Barrier(2)

    def remote():
        try:
            barrier.wait(timeout=30)
            for s in seeds:
                got_srv.append(server_suggest([60], None, nt, s))
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=remote)
    t.start()
    barrier.wait(timeout=30)
    got_loc = [tpe.suggest([60], dom, local, s) for s in seeds]
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert got_srv == want_srv and got_loc == want_loc
    assert want_srv == want_loc


@pytest.mark.cuda
def test_unbuilt_kernel_reached_by_two_threads_builds_once(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(ek, "_libs", {})
    monkeypatch.setattr(ek, "_BUILD_DIR", tmp_path)
    compiled = []
    real = ek.compile_library

    def counting(source, out):
        compiled.append(source.name)
        return real(source, out)

    monkeypatch.setattr(ek, "compile_library", counting)
    g = torch.Generator(device="cuda").manual_seed(2)
    z = torch.randn(31, 2048, device="cuda", generator=g)
    mix = []
    for k in (26, 257):
        mix += [torch.log_softmax(torch.randn(31, k, device="cuda",
                                              generator=g), dim=1),
                torch.randn(31, k, device="cuda", generator=g),
                torch.rand(31, k, device="cuda", generator=g) + 0.3]
    ek.reset_launches()
    barrier = threading.Barrier(2)
    outs, errors = [None, None], []

    def launch(i):
        try:
            barrier.wait(timeout=30)
            outs[i] = ek.ei_scores(z, *mix)
            torch.cuda.synchronize()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert sorted(compiled) == sorted(p.name for p in ek._SOURCES.values())
    assert ek.ei_scores.launches == 2
    assert ek.ei_scores.launches_by["f32"] == 2
    ref = ek.ei_scores_reference(z, *mix)
    for out in outs:
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_launch_counts_lose_no_update_under_threads():
    """Many threads launching at once, with a short switch interval: the
    wrapper's counts are read-modify-write updates, and none is lost."""
    import sys

    z = torch.randn(4, 64, device="cuda")
    mix = [torch.zeros(4, 3, device="cuda"), torch.zeros(4, 3, device="cuda"),
           torch.ones(4, 3, device="cuda")] * 2
    ek.build()
    ek.reset_launches()
    n_threads, per_thread = 8, 200
    errors = []

    def launch():
        try:
            for _ in range(per_thread):
                ek.ei_scores(z, *mix)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=launch) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert ek.ei_scores.launches == n_threads * per_thread
    assert ek.ei_scores.launches_by["f32"] == n_threads * per_thread
