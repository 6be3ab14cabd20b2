"""The joint (``multivariate=True``) TPE step of the PyTorch port against
hyperopt_tpu, and through every path that reaches it.

* The step, handed the uniforms of the JAX step's key schedule, against
  JAX's ``_suggest_one_joint_tel`` (its Pallas EI kernel in interpret
  mode) on the 10-dim flagship and on a nested conditional space: the
  joint totals agree to 1e-5 of the sheet's largest |total| (each sums
  ~P terms that agree to rtol 1e-5; the port sums them in a fixed order,
  JAX in XLA's), the winner is the same unless JAX's two best totals lie
  within that tolerance, and the row agrees as the factorized step's
  does (categorical columns exactly, the rest to rtol 1e-5).
* ``-3e38`` fills: two in one vector add up to ``±inf`` in float32 in
  both packages, with the same winner (sheets handed to both).
* The liar batch against JAX's ``suggest_many_seeded`` (same tolerance).
* Lanes: L = 1 and 3 equal the solo steps bit for bit (tolerance: none).
* CPU device mode at stride 1 lands the hosted joint run's trials, and
  ``fmin_fleet``/``fmin_device(n_runs=)`` lanes equal their solo runs,
  and a cohort's rows the solo suggests (equality).
* Docs stay valid on a conditional space (JAX's ``TestMultivariate``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.ops import step_ei as step_ei_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import device, fleet, tpe
from hyperopt_tpu_torch.fmin import _device_algo_kwargs
from hyperopt_tpu_torch.space import compile_space as compile_t
from test_torch_tpe import _history, _jax_step_uniforms, flagship

CPU = "cpu"
RTOL = 1e-5
N_CAP, N_CAND = 64, 128


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nested(pkg):
    """Two levels of conditional branches over every column family."""
    hp = pkg.hp
    return {
        "x": hp.uniform("x", -3.0, 3.0),
        "curve": hp.choice("curve", [
            {"amp": hp.loguniform("amp", -3.0, 1.0)},
            {"freq": hp.quniform("freq", 1.0, 9.0, 1.0),
             "inner": hp.choice("inner", [
                 {"w": hp.normal("w", 0.0, 1.0)},
                 {"k": hp.uniformint("k", 0, 5)}])}]),
    }


def _spy_totals(monkeypatch):
    """Record the joint totals each package's argmax sees."""
    seen = {"j": [], "t": []}
    orig_j, orig_t = step_ei_j.ei_argmax_stats, tpe.ei_argmax_stats

    def spy_j(x):
        seen["j"].append(x)
        return orig_j(x)

    def spy_t(x):
        seen["t"].append(x.numpy().copy())
        return orig_t(x)

    monkeypatch.setattr(step_ei_j, "ei_argmax_stats", spy_j)
    monkeypatch.setattr(tpe, "ei_argmax_stats", spy_t)
    return seen


def _jax_joint(kj, key, hist, seen, gamma=0.25, pw=1.0):
    """JAX's joint step, jitted, with the totals its argmax sees (the spy
    of :func:`_spy_totals` hands the traced vector out):
    ``((row, act, ei_best, ei_ties), total)``."""

    def run(key, vals, active, loss, ok):
        below, above = kj._split(loss, ok, np.float32(gamma))
        k_cat, *k_cont = jax.random.split(key, 1 + len(kj.groups))
        out = kj._suggest_one_joint_tel(k_cat, k_cont, vals, active, below,
                                        above, np.float32(pw))
        return out, seen["j"].pop()

    out, total = jax.jit(run)(key, *(jnp.asarray(a) for a in hist))
    return out, np.asarray(total)


def _total_tol(total_j):
    """The totals' tolerance: RTOL of the sheet's largest finite |total|.
    Each total sums ~P terms that agree to RTOL each, with cancellation,
    so a total near 0 keeps the error of its terms."""
    fin = np.abs(total_j[np.isfinite(total_j)])
    return RTOL * float(fin.max()) if fin.size else 0.0


def _same_winner(bi_t, bi_j, total_j):
    """The same winner, unless JAX's two best totals are within the
    totals' tolerance of each other."""
    if bi_t == bi_j:
        return True
    top = np.sort(total_j)[-2:]
    return bool(top[1] - top[0] <= _total_tol(total_j))


def _check_step(monkeypatch, space_fn, n_hist, seed):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    csj, cst = compile_j(space_fn(hj)), compile_t(space_fn(ht))
    hist = tpe_j._padded_history(_history(csj, n_hist, seed), N_CAP)
    kj = tpe_j.get_kernel(csj, N_CAP, N_CAND, 25, multivariate=True)
    kt = tpe.get_kernel(cst, N_CAP, N_CAND, 25, device=CPU,
                        multivariate=True)
    seen = _spy_totals(monkeypatch)
    key = jax.random.key(300 + seed)
    (row_j, act_j, best_j, ties_j), total_j = _jax_joint(kj, key, hist, seen)
    row_t, act_t, best_t, ties_t = kt._suggest_one_tel(
        *(torch.as_tensor(a) for a in hist), 0.25, 1.0,
        noise=_jax_step_uniforms(key, kj))
    (total_t,) = seen["t"]
    total_t = total_t[0]
    np.testing.assert_allclose(total_t, total_j, rtol=0.0,
                               atol=_total_tol(total_j))
    bi_t, bi_j = int(np.argmax(total_t)), int(np.argmax(total_j))
    assert _same_winner(bi_t, bi_j, total_j)
    if bi_t == bi_j:
        row_j = np.asarray(row_j)
        cat = [p.pid for p in cst.params if p.is_int]
        np.testing.assert_array_equal(row_t.numpy()[cat], row_j[cat])
        np.testing.assert_allclose(row_t.numpy(), row_j, rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
        np.testing.assert_allclose(float(best_t), float(best_j), rtol=RTOL)
        assert int(ties_t) == int(ties_j)
    return total_t, act_t


@pytest.mark.parametrize("seed", range(3))
def test_joint_step_with_jax_uniforms_matches_jax(monkeypatch, seed):
    total, _ = _check_step(monkeypatch, flagship, 50, seed)
    assert total.shape == (N_CAND,)


@pytest.mark.parametrize("seed", range(2))
def test_joint_step_on_a_nested_conditional_space(monkeypatch, seed):
    total, act = _check_step(monkeypatch, nested, 45, 10 + seed)
    # The winner's mask follows its own branches.
    cs = compile_t(nested(ht))
    assert act.numpy().tolist() != [True] * cs.n_params


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_two_fills_in_one_vector_overflow_alike(monkeypatch, sign):
    """Sheets handed to both packages' joint assembly: candidate 0 holds
    two ``sign·3e38`` columns (their sum overflows to ``sign·inf``),
    candidate 1 one fill plus finite scores, the rest finite (``+``) or
    one fill each (``-``: the finite parts vanish in the rounding, all tie
    at -3e38 and the first wins).  Both packages must give the same
    totals, winner, score and ties."""
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    space = {"a": ht.hp.uniform("a", 0.0, 1.0),
             "b": ht.hp.uniform("b", 0.0, 1.0),
             "c": ht.hp.choice("c", [0, 1, 2])}
    space_j = {"a": hj.hp.uniform("a", 0.0, 1.0),
               "b": hj.hp.uniform("b", 0.0, 1.0),
               "c": hj.hp.choice("c", [0, 1, 2])}
    csj, cst = compile_j(space_j), compile_t(space)
    n = 16
    kj = tpe_j.get_kernel(csj, 32, n, 25, multivariate=True)
    kt = tpe.get_kernel(cst, 32, n, 25, device=CPU, multivariate=True)
    rng = np.random.default_rng(0)
    (g,) = kj.groups
    v_cont = rng.uniform(0, 1, (len(g), n)).astype(np.float32)
    e_cont = rng.normal(0, 1, (len(g), n)).astype(np.float32)
    v_cat = rng.integers(0, 3, (1, n)).astype(np.float32)
    e_cat = rng.normal(0, 1, (1, n)).astype(np.float32)
    fill = np.float32(sign * 3e38)
    e_cont[0, 0] = fill                 # candidate 0: two fills
    e_cat[0, 0] = fill
    e_cont[1, 1] = fill                 # candidate 1: one fill
    if sign < 0:
        e_cont[0, 2:] = fill
        e_cont[0, 1] = 0.0
    monkeypatch.setattr(kj, "_cont_scores",
                        lambda *a, **k: (jnp.asarray(v_cont),
                                         jnp.asarray(e_cont)))
    monkeypatch.setattr(kj, "_cat_scores",
                        lambda *a, **k: (jnp.asarray(v_cat),
                                         jnp.asarray(e_cat)))
    monkeypatch.setattr(kt, "_cont_scores",
                        lambda *a, **k: (torch.as_tensor(v_cont)[None],
                                         torch.as_tensor(e_cont)[None]))
    monkeypatch.setattr(kt, "_cat_scores",
                        lambda *a, **k: (torch.as_tensor(v_cat)[None],
                                         torch.as_tensor(e_cat)[None]))
    seen = _spy_totals(monkeypatch)
    hist = tpe_j._padded_history(_history(csj, 24, 0), 32)
    key = jax.random.key(0)
    (row_j, act_j, best_j, ties_j), total_j = _jax_joint(kj, key, hist, seen)
    row_t, act_t, best_t, ties_t = kt._suggest_one_tel(
        *(torch.as_tensor(a) for a in hist), 0.25, 1.0,
        noise=_jax_step_uniforms(key, kj))
    (total_t,) = seen["t"]
    assert total_t[0, 0] == total_j[0] == sign * np.inf
    np.testing.assert_array_equal(np.isinf(total_t[0]), np.isinf(total_j))
    np.testing.assert_allclose(total_t[0], total_j, rtol=RTOL)
    np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
    assert float(best_t) == float(best_j)
    assert int(ties_t) == int(ties_j)


def test_liar_batch_matches_jax(monkeypatch):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    csj, cst = compile_j(flagship(hj)), compile_t(flagship(ht))
    m = 4
    kj = tpe_j.get_kernel(csj, N_CAP, N_CAND, 25, multivariate=True)
    kt = tpe.get_kernel(cst, N_CAP, N_CAND, 25, device=CPU,
                        multivariate=True)
    cat = [p.pid for p in cst.params if p.is_int]
    for seed in range(2):
        n_rows = 40 + 5 * seed
        hist = tpe_j._padded_history(_history(csj, n_rows, seed), N_CAP)
        want, _ = kj.suggest_many_seeded(seed, m, n_rows,
                                         *(jnp.asarray(a) for a in hist),
                                         0.25, 1.0)
        keys = jax.random.split(prng_key(np.uint32(seed)), m)
        got, acts = kt.suggest_many(
            m, n_rows, *(torch.as_tensor(a) for a in hist), 0.25, 1.0,
            noises=[_jax_step_uniforms(k, kj) for k in keys])
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy()[:, cat], want[:, cat])
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
        np.testing.assert_array_equal(acts.numpy(),
                                      csj.active_mask_host(want))


@pytest.mark.parametrize("n_lanes", [1, 3])
def test_lanes_equal_solo_steps(n_lanes):
    cst = compile_t(flagship(ht))
    csj = compile_j(flagship(hj))
    kt = tpe.get_kernel(cst, N_CAP, 32, 25, device=CPU, multivariate=True)
    hists = [tpe._padded_history(_history(csj, 30 + 7 * j, j), N_CAP)
             for j in range(n_lanes)]
    seeds = [11 + j for j in range(n_lanes)]
    stacked = [torch.as_tensor(np.stack(a)) for a in zip(*hists)]
    gens = [ht.space.make_generator(CPU, s) for s in seeds]
    rows, acts, best, ties = kt._suggest_lanes(*stacked, 0.25, 1.0, gens)
    for j, hist in enumerate(hists):
        gen = ht.space.make_generator(CPU, seeds[j])
        r, a, b, t = kt._suggest_one_tel(*(torch.as_tensor(x) for x in hist),
                                         0.25, 1.0, generator=gen)
        assert torch.equal(rows[j], r) and torch.equal(acts[j], a)
        assert torch.equal(best[j], b) and torch.equal(ties[j], t)


def _space_dev():
    return {"x": ht.hp.uniform("x", -5, 5),
            "c": ht.hp.choice("c", [
                {"kind": 0},
                {"kind": 1, "q": ht.hp.quniform("q", 0, 10, 1)}])}


SPACE_DEV = _space_dev()


def obj_dev(p):
    d = p["x"] - 1.0
    return d * d + torch.where(p["c"] > 0, p["q"], 0.0)


def obj_host(d):
    e = np.float32(d["x"]) - np.float32(1.0)
    extra = np.float32(d["c"]["q"]) if d["c"]["kind"] == 1 \
        else np.float32(0.0)
    return float(e * e + extra)


MV = dict(multivariate=True, n_EI_candidates=16, n_startup_jobs=8)


def _docs(t):
    return [({k: tuple(map(float, v))
              for k, v in sorted(d["misc"]["vals"].items())},
             float(d["result"]["loss"])) for d in t._dynamic_trials]


def test_device_mode_stride1_equals_hosted_joint_run():
    a, b = ht.Trials(), ht.Trials()
    algo = partial(tpe.suggest, **MV)
    ht.fmin(obj_host, SPACE_DEV, algo=algo, max_evals=30, trials=a,
            rstate=np.random.default_rng(4), show_progressbar=False,
            device=CPU)
    ht.fmin(obj_dev, SPACE_DEV, algo=algo, max_evals=30, trials=b,
            rstate=np.random.default_rng(4), show_progressbar=False,
            device=CPU, mode="device", sync_stride=1)
    assert _docs(a) == _docs(b)
    # The joint run differs from the factorized one.
    c = ht.Trials()
    ht.fmin(obj_host, SPACE_DEV, algo=partial(
        tpe.suggest, **dict(MV, multivariate=False)), max_evals=30,
        trials=c, rstate=np.random.default_rng(4), show_progressbar=False,
        device=CPU)
    assert _docs(a) != _docs(c)


def test_fmin_fleet_and_n_runs_lanes_equal_solo_runs():
    n = 24
    infos = fleet.fmin_fleet(obj_dev, SPACE_DEV, n_lanes=3, max_evals=n,
                             seed=6, sync_stride=8, device=CPU, **MV)
    _, info_r = ht.fmin_device(obj_dev, SPACE_DEV, max_evals=n, seed=6,
                               n_runs=3, device=CPU, **MV)
    for j, info in enumerate(infos):
        t = ht.Trials()
        ht.fmin(obj_dev, SPACE_DEV, algo=partial(tpe.suggest, **MV),
                max_evals=n, trials=t, rstate=np.random.default_rng(6 + j),
                show_progressbar=False, device=CPU, mode="device")
        solo = np.asarray([d["result"]["loss"] for d in t._dynamic_trials],
                          np.float32)
        np.testing.assert_array_equal(info["losses"], solo)
        np.testing.assert_array_equal(info_r["losses"][j], solo)


def test_cohort_rows_equal_solo_suggests():
    doms, exps = [], []
    for i in range(3):
        space = _space_dev()
        t = ht.Trials()
        ht.fmin(obj_host, space, algo=partial(tpe.suggest, **MV),
                max_evals=12 + i, trials=t,
                rstate=np.random.default_rng(20 + i),
                show_progressbar=False, device=CPU)
        dom = ht.Domain(obj_host, space)
        dom.cs.device = CPU
        doms.append(dom)
        exps.append(t)
    sched = fleet.CohortScheduler(**MV)
    reqs = [([len(t)], doms[i], t, 500 + i) for i, t in enumerate(exps)]
    d0 = fleet.dispatches
    got = sched.suggest(reqs)
    assert fleet.dispatches == d0 + 1
    for i, t in enumerate(exps):
        want = tpe.suggest([len(t)], doms[i], t, 500 + i, **MV)
        assert got[i][0]["misc"]["vals"] == want[0]["misc"]["vals"]


def test_docs_valid_on_conditional_space():
    """A port of JAX's ``TestMultivariate.test_docs_valid_on_conditional_
    space``: three joint proposals, each with the values of its own branch
    only."""
    space = {"curve": ht.hp.choice("curve", [
        {"kind": "flat"},
        {"kind": "wave", "amp": ht.hp.uniform("amp", 0.1, 2.0)}]),
        "x": ht.hp.uniform("x", -3, 3)}

    def fn(d):
        amp = d["curve"].get("amp", 0.0)
        return float((d["x"] - amp) ** 2)

    t = ht.Trials()
    ht.fmin(fn, space, algo=tpe.suggest, max_evals=25, trials=t,
            rstate=np.random.default_rng(0), show_progressbar=False,
            device=CPU)
    d = ht.Domain(fn, space)
    d.cs.device = CPU
    docs = tpe.suggest([500, 501, 502], d, t, 9, multivariate=True,
                       n_EI_candidates=128)
    assert len(docs) == 3
    for doc in docs:
        vals = doc["misc"]["vals"]
        if vals["curve"][0] == 0:
            assert vals["amp"] == []
        else:
            assert len(vals["amp"]) == 1


def test_device_mode_accepts_multivariate_and_suggest_quantile():
    for algo in (partial(tpe.suggest, multivariate=True),
                 tpe.suggest_quantile,
                 partial(tpe.suggest_quantile, multivariate=True,
                         verbose=False)):
        kw = _device_algo_kwargs(algo)
        assert set(kw) <= {"multivariate", "split", "verbose"}
    t = ht.Trials()
    ht.fmin(obj_dev, SPACE_DEV, algo=partial(tpe.suggest_quantile, **MV),
            max_evals=12, trials=t, rstate=np.random.default_rng(1),
            show_progressbar=False, device=CPU, mode="device")
    assert len(t) == 12
    assert device.eager_steps > 0
