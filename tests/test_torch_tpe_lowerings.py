"""The port's TPE step against the JAX package's sampler, split and fit
lowerings (``HYPEROPT_TPU_COMP_SAMPLER``, ``HYPEROPT_TPU_SPLIT_IMPL`` and
``HYPEROPT_TPU_FUSED_STEP`` there; the port takes ``comp_sampler`` as an
argument and has one split and one fit).

* ``comp_sampler="gumbel"``: the step, handed the uniforms JAX's Gumbel
  draws start from (``[n_cand, K]`` per column, ``[D, n_cand, kmax]`` for
  the categoricals), proposes JAX's row (categorical columns exactly, the
  rest to rtol 1e-5, as the icdf step); the candidate frequencies of the
  two samplers agree (two-sample χ², p > 0.01, as JAX's
  ``TestCatIcdfSampler``).
* The port's split gives the masks of JAX's ``topk`` and ``sort``
  lowerings (JAX's ``TestSplitImpl`` cases; equality), over lanes too.
* The port's fit (below and above in one batched sweep) proposes JAX's
  unfused step's row (same tolerance as the step), and its lane-folded
  fit equals the solo fit bit for bit.
* Every entry point checks the lowering before it builds anything, in
  startup too (:func:`tpe._lowering`).
* Device mode and the fleet on the CPU take the Gumbel sampler: lanes
  equal solo runs (equality).
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu_torch import dispatch, fleet, tpe
from hyperopt_tpu_torch.ops.gmm import gumbel_pick
from hyperopt_tpu_torch.space import compile_space as compile_t
from test_torch_tpe import _history, _jax_step_uniforms, flagship

CPU = "cpu"
N_CAP, N_CAND = 64, 128


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_gumbel_uniforms(key, kern):
    """The uniforms JAX's Gumbel lowering starts from: the key schedule of
    ``_jax_step_uniforms``, with ``uniform(kc, (n, K_b))`` (what
    ``jax.random.categorical`` hands ``gumbel``, ``gmm.py:300-312``) per
    column and ``uniform(k_cat, (D, n, kmax))`` (``tpe.py:770-774``)."""
    n = kern.n_cand
    k_b = min(kern.lf, kern.n_cap) + 1
    k_cat, *k_cont = jax.random.split(key, 1 + len(kern.groups))
    cont = []
    for g, kg in zip(kern.groups, k_cont):
        ucs, us = [], []
        for k in jax.random.split(kg, len(g)):
            kc, ku = jax.random.split(k)
            ucs.append(np.asarray(jax.random.uniform(kc, (n, k_b))))
            us.append(np.asarray(jax.random.uniform(ku, (n,))))
        cont.append((torch.as_tensor(np.stack(ucs)),
                     torch.as_tensor(np.stack(us))))
    cat = np.asarray(jax.random.uniform(
        k_cat, (len(kern.cat_pids), n, kern.cat_kmax)))
    return {"cont": cont, "cat": torch.as_tensor(cat)}


def _rows_agree(cst, got, want):
    cat = [p.pid for p in cst.params if p.is_int]
    np.testing.assert_array_equal(got[..., cat], want[..., cat])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("multivariate", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_gumbel_step_with_jax_uniforms_proposes_jax_row(monkeypatch, seed,
                                                        multivariate):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    monkeypatch.setenv("HYPEROPT_TPU_COMP_SAMPLER", "gumbel")
    csj, cst = compile_j(flagship(hj)), compile_t(flagship(ht))
    hist = tpe_j._padded_history(_history(csj, 50, seed), N_CAP)
    kj = tpe_j.get_kernel(csj, N_CAP, N_CAND, 25, multivariate=multivariate)
    assert kj.comp_sampler == "gumbel"
    kt = tpe.get_kernel(cst, N_CAP, N_CAND, 25, device=CPU,
                        comp_sampler="gumbel", multivariate=multivariate)
    key = jax.random.key(700 + seed)
    want, _ = kj._fn(key, *(jnp.asarray(a) for a in hist), np.float32(0.25),
                     np.float32(1.0))
    got, act = kt(*(torch.as_tensor(a) for a in hist), 0.25, 1.0,
                  noise=_jax_gumbel_uniforms(key, kj))
    want = np.asarray(want)
    _rows_agree(cst, got.numpy(), want)
    np.testing.assert_array_equal(act.numpy(),
                                  csj.active_mask_host(want[None])[0])


def test_gumbel_pick_is_jax_categorical():
    """``gumbel_pick`` on the uniforms of a key equals
    ``jax.random.categorical`` on that key (with a dead option)."""
    key = jax.random.key(3)
    with np.errstate(divide="ignore"):
        logits = np.log(np.asarray([0.1, 0.0, 0.6, 0.3], np.float32))
    want = np.asarray(jax.random.categorical(key, logits, shape=(4000,)))
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (4000, 4))))
    got = gumbel_pick(u, torch.as_tensor(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == 1).any()


def test_icdf_matches_gumbel_frequencies():
    """The categorical candidate draw under both samplers: the same
    distribution (two-sample χ², p > 0.01)."""
    cs = compile_t({"c": ht.hp.choice("c", list(range(5)))})
    rng = np.random.default_rng(0)
    n = 40
    vals = torch.as_tensor(rng.integers(0, 5, (n, 1)).astype(np.float32))
    active = torch.ones((n, 1), dtype=torch.bool)
    loss = (vals[:, 0] % 3).to(torch.float32)
    ok = torch.ones(n, dtype=torch.bool)

    def draws(sampler):
        kern = tpe._TpeKernel(cs, 64, 4000, 25, device=CPU,
                              comp_sampler=sampler)
        below, above = kern._split(loss, ok, 0.25)
        u = kern.draw_noise(torch.Generator().manual_seed(7))["cat"]
        cv, _ = kern._cat_scores(u, vals, active, below, above, 1.0)
        return cv[0].numpy().astype(int)

    cg, ci = draws("gumbel"), draws("icdf")
    assert cg.min() >= 0 and cg.max() <= 4
    tab = np.stack([np.bincount(cg, minlength=5),
                    np.bincount(ci, minlength=5)])
    tab = tab[:, tab.sum(axis=0) > 0]
    _, p, _, _ = stats.chi2_contingency(tab)
    assert p > 0.01, (tab, p)


def _splits(loss, ok, gamma, lf, split, impl):
    """The port's ``(below, above)`` and JAX's under ``split_impl=impl``."""
    k = SimpleNamespace(lf=lf, split=split)
    bt, at = tpe._TpeKernel._split(
        k, torch.as_tensor(loss, dtype=torch.float32), torch.as_tensor(ok),
        gamma)
    kj = SimpleNamespace(lf=lf, split=split, split_impl=impl)
    bj, aj = tpe_j._TpeKernel._split(kj, jnp.asarray(loss, jnp.float32),
                                     jnp.asarray(ok), gamma)
    return (bt.numpy(), at.numpy()), (np.asarray(bj), np.asarray(aj))


@pytest.mark.parametrize("impl", ["topk", "sort"])
@pytest.mark.parametrize("split", ["sqrt", "quantile"])
@pytest.mark.parametrize("seed", range(4))
def test_split_matches_jax_lowerings(impl, split, seed):
    rng = np.random.default_rng(seed)
    n_cap = 64
    n_ok = int(rng.integers(1, n_cap))
    loss = np.full(n_cap, np.inf, np.float32)
    loss[:n_ok] = rng.integers(0, 6, n_ok).astype(np.float32)   # ties
    loss[rng.integers(0, n_ok, 3)] = np.nan
    ok = np.zeros(n_cap, bool)
    ok[:n_ok] = True
    for gamma in (0.15, 0.25, 0.9):
        for lf in (3, 25, 100):
            (bt, at), (bj, aj) = _splits(loss, ok, gamma, lf, split, impl)
            np.testing.assert_array_equal(bt, bj)
            np.testing.assert_array_equal(at, aj)
            assert not np.any(bt & at)
            assert np.array_equal(bt | at, ok)


def test_split_below_is_the_k_smallest():
    loss = np.asarray([5, 1, 3, 2, 4, np.inf, np.inf], np.float32)
    ok = np.asarray([1, 1, 1, 1, 1, 0, 0], bool)
    for impl in ("topk", "sort"):
        (bt, _), (bj, _) = _splits(loss, ok, 0.5, 25, "quantile", impl)
        np.testing.assert_array_equal(bt, np.asarray([0, 1, 1, 1, 0, 0, 0],
                                                     bool))
        np.testing.assert_array_equal(bt, bj)


def test_split_over_lanes():
    """Lanes of the split equal their solo splits."""
    rng = np.random.default_rng(5)
    loss = rng.integers(0, 4, (3, 32)).astype(np.float32)
    ok = rng.random((3, 32)) < 0.8
    k = SimpleNamespace(lf=25, split="sqrt")
    b, a = tpe._TpeKernel._split(k, torch.as_tensor(loss),
                                 torch.as_tensor(ok), 0.25)
    for j in range(3):
        bj, aj = tpe._TpeKernel._split(k, torch.as_tensor(loss[j]),
                                       torch.as_tensor(ok[j]), 0.25)
        assert torch.equal(b[j], bj) and torch.equal(a[j], aj)


@pytest.mark.parametrize("seed", range(2))
def test_fit_proposes_jax_unfused_row(monkeypatch, seed):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    monkeypatch.setenv("HYPEROPT_TPU_FUSED_STEP", "0")
    csj, cst = compile_j(flagship(hj)), compile_t(flagship(ht))
    hist = tpe_j._padded_history(_history(csj, 50, seed), N_CAP)
    kj = tpe_j.get_kernel(csj, N_CAP, N_CAND, 25)
    assert not kj.fused_step
    kt = tpe.get_kernel(cst, N_CAP, N_CAND, 25, device=CPU)
    h = [torch.as_tensor(a) for a in hist]
    below, above = kt._split(h[2], h[3], 0.25)
    pw = torch.as_tensor([1.0], dtype=torch.float32)
    for gt in kt._gt:
        solo = kt._cont_fit(gt, *h[:2], below, above, 1.0)
        lanes = kt._cont_fit(gt, *(x[None] for x in h[:2]), below[None],
                             above[None], pw)
        for x, y in zip(solo, lanes):
            assert torch.equal(x, y[0])
    key = jax.random.key(900 + seed)
    want, _ = kj._fn(key, *(jnp.asarray(a) for a in hist), np.float32(0.25),
                     np.float32(1.0))
    got, _ = kt(*h, 0.25, 1.0, noise=_jax_step_uniforms(key, kj))
    _rows_agree(cst, got.numpy(), np.asarray(want))


def test_lowerings_are_validated():
    cs = compile_t(flagship(ht))
    with pytest.raises(ValueError, match="comp_sampler"):
        tpe.get_kernel(cs, 32, 8, 25, device=CPU, comp_sampler="normal")


FLEET_SPACE = {"x": ht.hp.uniform("x", -5, 5),
               "n": ht.hp.qnormal("n", 0, 4, 1),
               "c": ht.hp.choice("c", [0, 1, 2, 3])}


def fleet_obj(p):
    return torch.abs(p["x"] - 1.0) + p["c"] + 0.1 * torch.abs(p["n"])


ALGO = dict(n_EI_candidates=16, n_startup_jobs=6)


BAD_LOWERINGS = [dict(ei_impl="tpu"), dict(ei_precision="f16"),
                 dict(ei_topm=-1), dict(comp_sampler="normal"),
                 dict(split="median"), dict(cat_prior="flat")]


def _first_call(entry, cs, kw):
    """``entry``'s first call with the lowering ``kw``, on an empty history
    (a startup draw)."""
    dom = ht.Domain(lambda d: 0.0, cs)
    if entry == "suggest":
        tpe.suggest([0], dom, ht.Trials(), 0, **kw)
    elif entry == "dispatch":
        dispatch.suggest_dispatch([0], dom, ht.Trials(), 0, noise=[], **kw)
    elif entry == "cohort":
        fleet.CohortScheduler(**kw)
    elif entry == "kernel":
        tpe._TpeKernel(cs, 32, 8, 25, device=CPU, **kw)
    else:
        fleet.fmin_fleet(fleet_obj, cs, n_lanes=2, max_evals=4, device=CPU,
                         **kw)


@pytest.mark.parametrize("kw", BAD_LOWERINGS,
                         ids=lambda kw: next(iter(kw)))
@pytest.mark.parametrize("entry", ["suggest", "dispatch", "cohort", "kernel",
                                   "fleet"])
def test_entry_points_check_the_lowering_first(entry, kw):
    """A bad lowering raises at the first call, in startup too, before any
    kernel is built."""
    cs = compile_t(FLEET_SPACE)
    cs.device = CPU
    with pytest.raises(ValueError, match=next(iter(kw))):
        _first_call(entry, cs, kw)
    assert not cs.__dict__.get("_tpe_kernels")


@pytest.mark.parametrize("kw", [
    dict(comp_sampler="gumbel"),
    dict(comp_sampler="gumbel", multivariate=True),
], ids=["gumbel", "gumbel_mv"])
def test_fleet_lanes_equal_solo_runs(kw):
    n = 20
    infos = fleet.fmin_fleet(fleet_obj, FLEET_SPACE, n_lanes=3, max_evals=n,
                             seed=8, device=CPU, **ALGO, **kw)
    for j, info in enumerate(infos):
        _, solo = ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=n,
                                 seed=8 + j, device=CPU, **ALGO, **kw)
        np.testing.assert_array_equal(info["losses"], solo["losses"])
        np.testing.assert_array_equal(info["vals"], solo["vals"])


def test_gumbel_hosted_equals_device_stride1():
    space = {"x": ht.hp.uniform("x", -5, 5),
             "c": ht.hp.choice("c", [0, 1, 2])}

    def host(d):
        x = np.float32(d["x"])
        return float(x * x + np.float32(d["c"]))

    def dev(p):
        return p["x"] * p["x"] + p["c"]

    algo = partial(tpe.suggest, comp_sampler="gumbel", **ALGO)
    a, b = ht.Trials(), ht.Trials()
    ht.fmin(host, space, algo=algo, max_evals=20, trials=a,
            rstate=np.random.default_rng(3), show_progressbar=False,
            device=CPU)
    ht.fmin(dev, space, algo=algo, max_evals=20, trials=b,
            rstate=np.random.default_rng(3), show_progressbar=False,
            device=CPU, mode="device", sync_stride=1)
    assert [d["misc"]["vals"] for d in a._dynamic_trials] == \
        [d["misc"]["vals"] for d in b._dynamic_trials]
    assert [d["result"]["loss"] for d in a._dynamic_trials] == \
        [d["result"]["loss"] for d in b._dynamic_trials]
