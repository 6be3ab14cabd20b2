"""``anneal.py`` and ``mix.py`` of the PyTorch port against hyperopt_tpu.

* Anneal rows equal JAX's on JAX's draws: the port is handed the
  uniforms, normals, Gumbels and wide-randint uniforms JAX's kernel draws
  from its keys (one row from the key itself, a batch of 8 from
  ``split(key, 8)``), over a space with every family.  The incumbent picks
  are the same numpy stream in both.  Tolerance: categorical, integer and
  quantized columns exact; continuous ones rtol 1e-6 and atol 1e-6 (the
  float32 ``exp``/``log`` of the two libraries may differ in the last bit,
  and XLA may fuse ``lo + (hi - lo)·u`` into one FMA, which differs by a
  few ulps of the bounds where the sum cancels).
* ``mix.suggest`` picks JAX's sub-algorithm and hands it JAX's sub-seed
  for ten seeds (exact), by callable and by registry name.
* ``tests/test_anneal.py``'s behaviours, on the port's CPU path.
"""

import copy
import math
from functools import partial

import jax
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import anneal as anneal_j
from hyperopt_tpu import mix as mix_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import anneal, backends, mix

CPU = "cpu"
# Continuous columns: float32 rounding of the two libraries' exp/log and
# of a fused or unfused lo + (hi - lo)·u.
RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def every_family(pkg):
    hp = pkg.hp
    return {
        "u": hp.uniform("u", -2.0, 3.0),
        "lu": hp.loguniform("lu", -3.0, 1.0),
        "qu": hp.quniform("qu", 0.0, 10.0, 2.5),
        "qlu": hp.qloguniform("qlu", 0.0, 4.0, 1.0),
        "n": hp.normal("n", 1.0, 2.0),
        "ln": hp.lognormal("ln", 0.0, 0.5),
        "qn": hp.qnormal("qn", 0.0, 3.0, 1.0),
        "qln": hp.qlognormal("qln", 0.0, 1.0, 0.5),
        "ri": hp.randint("ri", 3, 9),
        "rw": hp.randint("rw", 0, 5000),
        "ui": hp.uniformint("ui", -2, 4),
        "pc": hp.pchoice("pc", [(0.2, "a"), (0.5, "b"), (0.3, "c")]),
        "br": hp.choice("br", [{"k": 0},
                               {"k": 1, "w": hp.uniform("w", 0.0, 1.0)}]),
    }


def _loss(vals):
    return float(sum(abs(v[0]) for v in vals.values() if v) % 7.0)


def _histories(n, seed=3):
    """The same ``n`` finished trials in both packages (JAX's prior draws,
    losses a function of the values)."""
    dj = hj.base.Domain(lambda cfg: 0.0, every_family(hj))
    dt = ht.Domain(lambda cfg: 0.0, every_family(ht))
    dt.cs.device = CPU
    docs = hj.rand.suggest(list(range(n)), dj, hj.Trials(), seed)
    for d in docs:
        d["state"] = hj.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": _loss(d["misc"]["vals"])}
    tj = hj.Trials()
    tj.insert_trial_docs(copy.deepcopy(docs))
    tj.refresh()
    tt = ht.Trials()
    tt.insert_trial_docs(copy.deepcopy(docs))
    tt.refresh()
    hj_h, ht_h = tj.history(dj.cs), tt.history(dt.cs)
    np.testing.assert_array_equal(hj_h["vals"], ht_h["vals"])
    return dj, tj, dt, tt


def jax_anneal_noise(cs_j, seed, n):
    """The draws of JAX's anneal kernel for ``n`` rows, in the port's
    ``noise`` layout."""
    key = prng_key(int(seed) % (2 ** 32))
    keys = [key] if n == 1 else list(jax.random.split(key, n))
    out = {"uf": [], "nf": [], "cat": [], "wide": []}
    f32 = jax.numpy.float32
    for k in keys:
        k_u, k_n, k_c, k_w = jax.random.split(k, 4)
        out["uf"].append(jax.random.uniform(k_u, (len(cs_j._uf),), f32))
        out["nf"].append(jax.random.normal(k_n, (len(cs_j._nf),), f32))
        out["cat"].append(jax.random.gumbel(
            k_c, (len(cs_j._cat), cs_j.cat_kmax), f32))
        out["wide"].append(jax.random.uniform(k_w, (len(cs_j._wide),), f32))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def assert_docs_match(got, want, cs):
    assert [d["tid"] for d in got] == [d["tid"] for d in want]
    exact = {p.label for p in cs.params if p.is_int or p.q}
    for g, w in zip(got, want):
        gv, wv = g["misc"]["vals"], w["misc"]["vals"]
        assert set(gv) == set(wv)
        for label in wv:
            assert len(gv[label]) == len(wv[label]), label
            if not wv[label]:
                continue
            if label in exact:
                assert gv[label] == wv[label], label
            else:
                np.testing.assert_allclose(gv[label], wv[label], rtol=RTOL,
                                           atol=ATOL, err_msg=label)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("n_hist", [1, 30])
def test_rows_equal_jax_on_jax_draws(n, n_hist):
    dj, tj, dt, tt = _histories(n_hist)
    ids = list(range(n_hist, n_hist + n))
    for seed in (0, 11, 2 ** 33 + 5):
        want = anneal_j.suggest(ids, dj, tj, seed)
        got = anneal.suggest(ids, dt, tt, seed,
                             noise=jax_anneal_noise(dj.cs, seed, n))
        assert_docs_match(got, want, dt.cs)


def test_cold_start_is_random_search():
    dt = ht.Domain(lambda cfg: 0.0, every_family(ht))
    dt.cs.device = CPU
    got = anneal.suggest([0, 1], dt, ht.Trials(), 4)
    want = ht.rand.suggest([0, 1], dt, ht.Trials(), 4)
    assert [d["misc"]["vals"] for d in got] == \
        [d["misc"]["vals"] for d in want]
    assert anneal.suggest([], dt, ht.Trials(), 4) == []


def test_noise_shape_is_checked():
    dj, tj, dt, tt = _histories(5)
    noise = jax_anneal_noise(dj.cs, 1, 2)
    with pytest.raises(ValueError, match="noise"):
        anneal.suggest([5], dt, tt, 1, noise=noise)


def test_own_draws_in_bounds_and_deterministic():
    _, _, dt, tt = _histories(30)
    a = anneal.suggest(list(range(30, 38)), dt, tt, 9)
    b = anneal.suggest(list(range(30, 38)), dt, tt, 9)
    assert [d["misc"]["vals"] for d in a] == [d["misc"]["vals"] for d in b]
    for d in a:
        v = d["misc"]["vals"]
        assert -2.0 <= v["u"][0] <= 3.0
        assert math.exp(-3.0) <= v["lu"][0] <= math.exp(1.0)
        assert 3 <= v["ri"][0] < 9 and 0 <= v["rw"][0] < 5000
        assert -2 <= v["ui"][0] <= 4 and v["qu"][0] % 2.5 == 0


# -- mix -----------------------------------------------------------------------


def _recorders(log):
    def make(name):
        def algo(new_ids, domain, trials, seed):
            log.append((name, seed))
            return []
        return algo
    return make("a"), make("b"), make("c")


def test_mix_picks_jax_sub_algorithm_and_seed():
    log_j, log_t = [], []
    aj, bj, cj = _recorders(log_j)
    at, bt, ct = _recorders(log_t)
    for seed in range(10):
        mix_j.suggest([0], None, None, seed,
                      p_suggest=[(0.2, aj), (0.5, bj), (0.3, cj)])
        mix.suggest([0], None, None, seed,
                    p_suggest=[(0.2, at), (0.5, bt), (0.3, ct)])
    assert log_t == log_j
    assert len({name for name, _ in log_t}) > 1


def test_mix_resolves_registry_names():
    backends.register_backend("mix_probe_t", lambda ids, d, t, seed: [seed])
    try:
        got = [mix.suggest([0], None, None, s,
                           p_suggest=[(0.5, "mix_probe_t"),
                                      (0.5, "mix_probe_t")])
               for s in range(3)]
    finally:
        with backends.contract._REGISTRY_LOCK:
            backends.contract._REGISTRY.pop("mix_probe_t", None)
    assert all(len(g) == 1 for g in got)
    with pytest.raises(backends.UnknownBackend):
        mix.suggest([0], None, None, 0, p_suggest=[(1.0, "nope")])


def test_mix_probability_validation():
    with pytest.raises(ValueError, match="sum to"):
        mix.suggest([0], None, None, 0, p_suggest=[(0.5, ht.rand.suggest)])


# -- tests/test_anneal.py's behaviours ----------------------------------------


def quadratic1():
    return {"x": ht.hp.uniform("x", -5, 5)}, lambda d: (d["x"] - 3.0) ** 2


def branin_domain():
    def branin(d):
        x, y = d["x"], d["y"]
        a, b, c = 1.0, 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
        r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
        return (a * (y - b * x ** 2 + c * x - r) ** 2
                + s * (1 - t) * math.cos(x) + s)
    return ({"x": ht.hp.uniform("x", -5, 10),
             "y": ht.hp.uniform("y", 0, 15)}, branin)


def q1_choice():
    hp = ht.hp
    space = {"p": hp.choice("p", [
        {"kind": "flat", "x": hp.uniform("x_flat", -5, 5)},
        {"kind": "centered", "x": hp.uniform("x_centered", -5, 5)}])}

    def fn(d):
        if d["p"]["kind"] == "centered":
            return (d["p"]["x"] - 3.0) ** 2
        return 1.0 + d["p"]["x"] ** 2 * 0.01
    return space, fn


def _run(space, fn, algo, seed, max_evals, **kw):
    t = ht.Trials()
    ht.fmin(fn, space, algo=algo, max_evals=max_evals, trials=t,
            rstate=np.random.default_rng(seed), device=CPU,
            show_progressbar=False, **kw)
    return t


@pytest.mark.parametrize("domain,thresh,budget", [
    (quadratic1, 0.1, 80), (branin_domain, 2.0, 150), (q1_choice, 0.5, 120)])
def test_anneal_converges(domain, thresh, budget):
    space, fn = domain()
    best = np.median([
        _run(space, fn, anneal.suggest, s, budget).best_trial["result"]["loss"]
        for s in (0, 1, 2)])
    assert best <= thresh, best


def test_shrinks_toward_incumbent():
    space, fn = quadratic1()
    t = _run(space, fn, anneal.suggest, 0, 80)
    xs = np.asarray([d["misc"]["vals"]["x"][0] for d in t.trials])
    assert np.abs(xs[60:] - 3.0).mean() < np.abs(xs[:20] - 3.0).mean()


def test_conditional_space_docs_valid():
    hp = ht.hp
    space = {"x": hp.uniform("x", -5, 5),
             "curve": hp.choice("curve", [
                 {"kind": "plain"},
                 {"kind": "cos", "amp": hp.uniform("amp", 0.5, 2.0)}])}

    def fn(d):
        if d["curve"]["kind"] == "plain":
            return -math.exp(-(d["x"] ** 2))
        return -d["curve"]["amp"] * math.exp(-(d["x"] ** 2))
    t = _run(space, fn, anneal.suggest, 0, 40)
    for doc in t:
        vals = doc["misc"]["vals"]
        assert (vals["amp"] == []) == (vals["curve"][0] == 0)


def test_mixed_dists_run():
    t = _run(every_family(ht), lambda d: _loss({"u": [d["u"]]}),
             "anneal", 0, 30)
    assert len(t) == 30 and t.best_trial["result"]["loss"] is not None


def test_batched_suggest():
    space, fn = quadratic1()
    t = _run(space, fn, anneal.suggest, 0, 40, max_queue_len=4)
    assert len(t) == 40
    xs = [d["misc"]["vals"]["x"][0] for d in t.trials[-4:]]
    assert len(set(xs)) == 4
    assert t.best_trial["result"]["loss"] < 0.1


def test_mix_routes_and_epsilon_greedy():
    space, fn = quadratic1()
    t = _run(space, fn, partial(mix.suggest, p_suggest=[
        (0.5, ht.rand.suggest), (0.5, anneal.suggest)]), 0, 40)
    assert len(t) == 40
    t = _run(space, fn, partial(mix.suggest, p_suggest=[
        (0.2, "rand"), (0.8, "tpe")]), 1, 60)
    assert t.best_trial["result"]["loss"] <= 0.1
