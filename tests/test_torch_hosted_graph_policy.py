"""Which hosted TPE steps of the PyTorch port replay a CUDA graph, on the
CPU.

On CUDA a one-proposal step without ``noise`` on a plain ``_TpeKernel``
replays its kernel's captured graph (``tpe._HostedStep``).  Here: the
policy (``tpe._takes_graph``) refuses the CPU, a batch, ``noise=`` and a
sharded kernel; a CPU study never reaches the graph path, the
``tpe.graph.*`` counters exist and stay at 0, and its proposals are the
bits of a stored run; the kernels hold at most ``_HOSTED_GRAPH_CAP``
hosted graphs per space and a failed capture falls back to the eager
step for good; a space whose kernels hold graphs pickles without them.
The graphs themselves run on the card
(``tests_torch_cuda/test_torch_cuda_hosted_graph.py``).
"""

import json
import pickle
import threading
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import dispatch, hp, tpe
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.space import compile_space, make_generator

STORED = Path(__file__).resolve().parent / "data" / "torch_tpe_cpu_study.json"
COUNTERS = ("tpe.graph.captures", "tpe.graph.replays",
            "tpe.graph.capture_ms", "tpe.graph.eager_steps")
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def space():
    return {"u": hp.uniform("u", -5.0, 5.0),
            "lu": hp.loguniform("lu", -4.0, 2.0),
            "q": hp.quniform("q", 0.0, 20.0, 2.0),
            "qn": hp.qnormal("qn", 0.0, 4.0, 1.0),
            "c": hp.choice("c", [0, 1, 2, 3]),
            "branch": hp.choice("branch", [
                {"kind": "a", "lr": hp.loguniform("lr", -6.0, 0.0)},
                {"kind": "b", "depth": hp.uniformint("depth", 1, 8)}])}


def objective(cfg):
    b = cfg["branch"]
    extra = (np.log(b["lr"]) ** 2 if b["kind"] == "a"
             else (b["depth"] - 3) ** 2)
    return ((cfg["u"] - 1.0) ** 2 + np.log(cfg["lu"]) ** 2
            + 0.1 * (cfg["q"] - 8) ** 2 + 0.05 * cfg["qn"] ** 2
            + 0.5 * cfg["c"] + 0.1 * extra)


def study(max_queue_len):
    """The stored run's study: 40 trials, 10 of them startup."""
    trials = ht.Trials()
    ht.fmin(objective, space(), algo=partial(tpe.suggest, n_startup_jobs=10),
            max_evals=40, trials=trials,
            rstate=np.random.default_rng(20261018), device="cpu",
            show_progressbar=False, max_queue_len=max_queue_len)
    return trials


def counters():
    snap = registry().snapshot()["counters"]
    return {name: snap.get(name) for name in COUNTERS}


class _ShardedStandIn(tpe._TpeKernel):
    """A subclass of the plain kernel, as ``dispatch.ShardedTpeKernel``
    is."""


def _bare(cls):
    # The policy reads the kernel's type only: no device tensors needed.
    return cls.__new__(cls)


@pytest.mark.parametrize("dev, n, noise, cls, takes", [
    (CPU, 1, None, tpe._TpeKernel, False),
    (CUDA, 2, None, tpe._TpeKernel, False),
    (CUDA, 8, None, tpe._TpeKernel, False),
    (CUDA, 1, {"cont": [], "cat": None}, tpe._TpeKernel, False),
    (CUDA, 1, None, _ShardedStandIn, False),
    (CUDA, 1, None, dispatch.ShardedTpeKernel, False),
    (CUDA, 1, None, tpe._TpeKernel, True),
], ids=["cpu", "batch2", "batch8", "noise", "subclass", "sharded", "takes"])
def test_graph_policy(dev, n, noise, cls, takes):
    assert tpe._takes_graph(_bare(cls), dev, n, noise) is takes


@pytest.fixture
def no_graph(monkeypatch):
    """Fail the test if any step reaches the graph path."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU step reached the graph path")

    monkeypatch.setattr(tpe, "_replay_step", refuse)
    monkeypatch.setattr(tpe, "_HostedStep", refuse)


@pytest.mark.parametrize("name, max_queue_len", [("serial", 1),
                                                 ("batch3", 3)])
def test_cpu_study_takes_no_graph_and_matches_the_stored_run(
        no_graph, name, max_queue_len):
    before = counters()
    assert all(v is not None for v in before.values()), before
    trials = study(max_queue_len)
    assert counters() == before
    stored = json.loads(STORED.read_text())[name]
    got = [{k: [float(x).hex() for x in v]
            for k, v in sorted(d["misc"]["vals"].items())}
           for d in sorted(trials.trials, key=lambda d: d["tid"])]
    assert len(got) == len(stored) == 40
    for tid, (g, s) in enumerate(zip(got, stored)):
        assert g == s, f"trial {tid}: {g} != {s}"


def test_counters_exist_and_read_zero_on_the_cpu(no_graph):
    study(1)
    assert counters() == dict.fromkeys(COUNTERS, 0.0)


def test_noise_step_runs_eagerly_and_equals_the_seeded_step(no_graph):
    """A ``noise=`` step takes the eager path; uniforms drawn from the
    seed's generator propose what the seed proposes."""
    trials = study(1)
    domain = ht.Domain(objective, space())
    cs = domain.cs
    seed = 123456789

    def acquire(n_cap):
        return tpe.get_kernel(cs, n_cap, 24, 25, device="cpu")

    def row(noise):
        handle = tpe._dispatch_with(acquire, [1000], domain, trials, seed,
                                    1.0, 20, 0.25, True, None, noise=noise)
        return tpe._force_rows(handle)[0]

    kern = acquire(tpe._bucket(len(trials.trials)))
    noise = kern.draw_noise(make_generator(CPU, seed % 2 ** 32))
    np.testing.assert_array_equal(row(noise), row(None))


class _FakeStep:
    """Stands in for ``_HostedStep`` (which needs the card): records its
    runs, or fails its capture."""

    fail = False

    def __init__(self, kern, gamma, prior_weight):
        self.key = (gamma, prior_weight)
        self.runs = 0
        self.retired = False
        self.used = next(tpe._HOSTED_CLOCK)

    def retire(self):
        self.retired = True

    def run(self, hist, seed):
        if self.fail:
            raise tpe._HostedCaptureError("capture invalidated")
        self.runs += 1
        return ("row", seed)


def _fake_kernel(cs, n_cap=32):
    """A kernel in the space's kernel cache, as ``get_kernel`` leaves it."""
    kern = SimpleNamespace(cs=cs, n_cap=n_cap, hosted={}, uncapturable=False)
    cs.__dict__.setdefault("_tpe_kernels", {})[("fake", n_cap)] = kern
    return kern


class _Count:
    """Stands in for the registry's replay counter, which stays at 0 on
    the CPU."""

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


@pytest.fixture
def cs():
    """The space, compiled (``compile_space`` caches it), with no kernels
    cached before or after the test (they are rebuilt on demand)."""
    compiled = compile_space(space())
    compiled.__dict__.pop("_tpe_kernels", None)
    yield compiled
    compiled.__dict__.pop("_tpe_kernels", None)


@pytest.fixture
def replays(monkeypatch):
    count = _Count()
    monkeypatch.setattr(tpe, "_GRAPH_REPLAYS", count)
    return count


def test_hosted_graphs_are_cached_per_space_least_recently_used_out(
        monkeypatch, replays, cs):
    monkeypatch.setattr(tpe, "_HostedStep", _FakeStep)
    kerns = [_fake_kernel(cs, 32 << i) for i in range(tpe._HOSTED_GRAPH_CAP)]
    for k in kerns:
        assert tpe._replay_step(k, None, 0.25, 1.0, 7) == ("row", 7)
    # Same kernel, gamma rounded to the same float32: the same graph.
    assert tpe._replay_step(kerns[0], None, np.float32(0.25), 1.0, 8) \
        == ("row", 8)

    def held():
        return {(k.n_cap, key): step for k in kerns
                for key, step in k.hosted.items()}

    assert len(held()) == tpe._HOSTED_GRAPH_CAP
    assert kerns[0].hosted[(0.25, 1.0)].runs == 2
    # One more graph evicts the least recently used, kerns[1]'s, and
    # retires it (waits for its last replay).
    second = kerns[1].hosted[(0.25, 1.0)]
    tpe._replay_step(kerns[0], None, 0.5, 1.0, 9)
    assert len(held()) == tpe._HOSTED_GRAPH_CAP
    assert not kerns[1].hosted and second.retired
    assert set(kerns[0].hosted) == {(0.25, 1.0), (0.5, 1.0)}
    assert not any(step.retired for step in held().values())
    assert replays.value == tpe._HOSTED_GRAPH_CAP + 2


def test_failed_capture_marks_the_kernel_and_runs_eagerly(monkeypatch,
                                                          replays, cs):
    monkeypatch.setattr(tpe, "_HostedStep",
                        type("_Failing", (_FakeStep,), {"fail": True}))
    kern = _fake_kernel(cs)
    assert tpe._replay_step(kern, None, 0.25, 1.0, 7) is None
    assert kern.uncapturable
    assert not kern.hosted
    # Later steps of the kernel do not try again.
    monkeypatch.setattr(tpe, "_HostedStep", _FakeStep)
    assert tpe._replay_step(kern, None, 0.25, 1.0, 8) is None
    assert not kern.hosted
    assert replays.value == 0


def test_a_space_holding_hosted_graphs_pickles_without_them(cs):
    kern = tpe.get_kernel(cs, 32, 24, 25, device="cpu")
    held = SimpleNamespace(lock=threading.Lock())
    kern.hosted[(0.25, 1.0)] = held
    back = pickle.loads(pickle.dumps(cs))
    assert "_tpe_kernels" not in back.__dict__
    assert back.n_params == cs.n_params
    assert tpe.get_kernel(back, 32, 24, 25, device="cpu").hosted == {}
    assert kern.hosted[(0.25, 1.0)] is held
