"""The hosted TPE step replayed as a CUDA graph, on the card (the CPU
half: ``tests/test_torch_hosted_graph_policy.py``).

* Over 200-trial studies on Branin and on the flagship space (density,
  quantized, lattice and choice columns), three seeds each, every TPE
  proposal of ``tpe.suggest`` (a replay after each bucket's first step)
  equals, bit for bit, the eager ``_TpeKernel.__call__`` on the same
  padded history and generator seed; ``tpe.graph.replays`` counts the TPE
  steps after each bucket's first.
* Two threads suggesting on one kernel, one of them on a stream of its
  own, and a dispatch made before the previous handle's fetch, each get
  their own rows.
* The north star's step: the flagship space at ``n_dims`` 50 (53
  parameters) resumed at 1,000 finished trials, 10,000 candidates, bucket
  1,024: replayed proposals equal the eager step's bits, and the gauge
  ``tpe.graph.pool_bytes`` reads the pool of the graph just captured.
"""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import base, hp, tpe
from hyperopt_tpu_torch.history import _padded_history
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.space import (compile_space, make_generator,
                                      resolve_device)

SPACES = Path(__file__).resolve().parent.parent / "portbench" / "spaces"
GAMMA, PRIOR_WEIGHT, N_STARTUP = 0.25, 1.0, 20


def _space_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_hosted_graph_{name}", SPACES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counter(name):
    return registry().snapshot()["counters"].get(name, 0.0)


def _eager_row(cs, h, seed, n_cand=24):
    """The eager step's row for history ``h`` (``Trials.history``) under
    ``seed``, on the kernel the hosted step uses."""
    n_cap = tpe._bucket(h["vals"].shape[0])
    dev = resolve_device(cs.device)
    kern = tpe.get_kernel(cs, n_cap, n_cand, 25, device=dev)
    hist = [torch.as_tensor(a, device=dev)
            for a in _padded_history(h, n_cap)]
    gen = make_generator(dev, int(seed) % (2 ** 32))
    row, _ = kern(*hist, GAMMA, PRIOR_WEIGHT, generator=gen)
    return row.cpu().numpy(), n_cap


def _fresh(cs):
    """Drop the space's cached kernels and the graphs they hold: the next
    study builds, steps and captures every bucket anew."""
    tpe.wait_prewarm()
    cs.__dict__.pop("_tpe_kernels", None)


@pytest.mark.cuda
@pytest.mark.parametrize("name, n_dims", [("branin", 2), ("flagship", 10)])
def test_replayed_proposals_equal_the_eager_step(name, n_dims):
    mod = _space_module(name)
    labels = mod.objective_labels(n_dims)

    def objective(cfg):
        return mod.objective({lab: float(cfg[lab]) for lab in labels})

    space = mod.build(hp, n_dims)
    cs = compile_space(space)
    _fresh(cs)
    for k, seed in enumerate((11, 2 ** 31 + 5, 987654321)):
        steps, buckets, mismatches = 0, set(), []

        def algo(new_ids, domain, trials, seed):
            nonlocal steps
            h = trials.history(domain.cs)
            tpe_step = int(h["ok"].sum()) >= N_STARTUP
            if tpe_step:
                want, n_cap = _eager_row(domain.cs, h, seed)
            handle = tpe.suggest_dispatch(new_ids, domain, trials, seed)
            docs = tpe.suggest_materialize(handle)
            if tpe_step:
                got = tpe._force_rows(handle)[0][0]
                steps += 1
                buckets.add(n_cap)
                if got.tobytes() != want.tobytes():
                    mismatches.append((len(trials.trials), got, want))
            return docs

        replays0 = _counter("tpe.graph.replays")
        captures0 = _counter("tpe.graph.captures")
        eager0 = _counter("tpe.graph.eager_steps")
        trials = ht.Trials()
        ht.fmin(objective, space, algo=algo, max_evals=200, trials=trials,
                rstate=np.random.default_rng(seed), show_progressbar=False)
        assert steps == 180
        assert buckets == {32, 64, 128, 256}
        assert not mismatches, mismatches[:3]
        # The first study steps each bucket's kernel eagerly once, then
        # captures; later studies replay every step.
        first = len(buckets) if k == 0 else 0
        assert _counter("tpe.graph.captures") - captures0 == first
        assert _counter("tpe.graph.replays") - replays0 == steps - first
        assert _counter("tpe.graph.eager_steps") == eager0


def _history(n, seed):
    """A ``Trials`` with ``n`` finished Branin-like trials."""
    rng = np.random.default_rng(seed)
    trials = ht.Trials()
    docs = []
    for tid in range(n):
        doc = base.new_trial_doc(tid)
        x, y = float(rng.uniform(-5, 10)), float(rng.uniform(0, 15))
        doc["misc"]["idxs"] = {"x": [tid], "y": [tid]}
        doc["misc"]["vals"] = {"x": [x], "y": [y]}
        doc["state"] = base.JOB_STATE_DONE
        doc["result"] = {"loss": (x - 2) ** 2 + (y - 3) ** 2,
                         "status": base.STATUS_OK}
        docs.append(doc)
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials


SPACE = {"x": hp.uniform("x", -5.0, 10.0), "y": hp.uniform("y", 0.0, 15.0)}


def _rows(trials, seed):
    domain = base.Domain(lambda cfg: 0.0, SPACE)
    return tpe.suggest_dispatch([len(trials.trials)], domain, trials, seed)


@pytest.fixture
def two_histories():
    """Two histories in one bucket (64) of one kernel, which has stepped
    and captured, and the eager rows of each under a few seeds."""
    a, b = _history(40, 1), _history(45, 2)
    cs = compile_space(SPACE)
    for trials in (a, b):
        tpe._force_rows(_rows(trials, 0))
    seeds = [3 + 7919 * i for i in range(12)]
    want = {(id(t), s): _eager_row(cs, t.history(cs), s)[0]
            for t in (a, b) for s in seeds}
    return a, b, seeds, want


@pytest.mark.cuda
def test_threads_on_one_kernel_get_their_own_rows(two_histories):
    a, b, seeds, want = two_histories
    side = torch.cuda.Stream()
    errors, got = [], {}

    def client(trials, stream):
        try:
            with torch.cuda.stream(stream):
                for _ in range(5):
                    for s in seeds:
                        row = tpe._force_rows(_rows(trials, s))[0][0]
                        got.setdefault((id(trials), s), []).append(row)
        except Exception as e:      # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(a, None)),
               threading.Thread(target=client, args=(b, side))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 2 * len(seeds)
    for key, rows in got.items():
        for row in rows:
            np.testing.assert_array_equal(row, want[key])


@pytest.mark.cuda
def test_dispatch_before_the_previous_fetch_gets_its_own_rows(two_histories):
    a, b, seeds, want = two_histories
    replays0 = _counter("tpe.graph.replays")
    handles = [(t, s, _rows(t, s)) for s in seeds for t in (a, b)]
    for t, s, handle in reversed(handles):
        np.testing.assert_array_equal(tpe._force_rows(handle)[0][0],
                                      want[(id(t), s)])
    assert _counter("tpe.graph.replays") - replays0 == len(handles)


@pytest.mark.cuda
def test_flagship_step_at_bucket_1024_replays_the_eager_bits():
    from portbench import program
    from portbench.reference import space as rspace

    mod = _space_module("flagship")
    n_dims, n_history, n_cand = 50, 1000, 10000
    ps = rspace.params(mod.build(rspace.PLAIN_HP, n_dims))
    rng = np.random.default_rng(2 ** 31 + 17)
    vals, live = rspace.sample(ps, n_history, rng)
    loss = rng.normal(0.0, 1.0, n_history)
    trials = program.trials_with(program.history_docs(ps, vals, live, loss,
                                                      range(n_history)))
    space = mod.build(hp, n_dims)
    domain = base.Domain(lambda cfg: 0.0, space)
    cs = domain.cs
    _fresh(cs)
    h = trials.history(cs)
    assert len(ps) == cs.n_params == 53
    captures0 = _counter("tpe.graph.captures")
    seeds = [2 ** 31 + 7 * i for i in range(4)]
    for i, seed in enumerate(seeds):
        want, n_cap = _eager_row(cs, h, seed, n_cand)
        handle = tpe.suggest_dispatch([n_history], domain, trials, seed,
                                      n_EI_candidates=n_cand)
        got = tpe._force_rows(handle)[0][0]
        assert n_cap == 1024
        assert got.tobytes() == want.tobytes(), (i, got, want)
        if i == 1:
            # The kernel's second step captured its graph.
            assert _counter("tpe.graph.captures") - captures0 == 1
            kern = tpe.get_kernel(cs, n_cap, n_cand, 25,
                                  device=resolve_device(cs.device))
            step = kern.hosted[(GAMMA, PRIOR_WEIGHT)]
            pool = tpe._pool_bytes(step.graph)
            assert pool > 0
            assert registry().snapshot()["gauges"][
                "tpe.graph.pool_bytes"] == float(pool)
    assert _counter("tpe.graph.captures") - captures0 == 1
    _fresh(cs)
