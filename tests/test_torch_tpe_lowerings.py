"""The sampler, split and fit lowerings of the port's TPE step
(``comp_sampler``, ``split_impl``, ``fused_step``: arguments here, the JAX
package's ``HYPEROPT_TPU_COMP_SAMPLER``, ``HYPEROPT_TPU_SPLIT_IMPL`` and
``HYPEROPT_TPU_FUSED_STEP`` there) against hyperopt_tpu.

* ``comp_sampler="gumbel"``: the step, handed the uniforms JAX's Gumbel
  draws start from (``[n_cand, K]`` per column, ``[D, n_cand, kmax]`` for
  the categoricals), proposes JAX's row (categorical columns exactly, the
  rest to rtol 1e-5, as the icdf step); the candidate frequencies of the
  two samplers agree (two-sample χ², p > 0.01, as JAX's
  ``TestCatIcdfSampler``).
* ``split_impl="sort"`` gives the masks of ``"topk"`` and of JAX's sort
  lowering (JAX's ``TestSplitImpl`` cases; equality).
* ``fused_step=False`` equals ``True`` bit for bit, and proposes JAX's
  unfused step's row (same tolerance as the step).
* Device mode and the fleet on the CPU take every lowering: lanes equal
  solo runs, and ``sort``/unfused runs land the default's trials
  (equality).
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
from hyperopt_tpu_torch import fleet, tpe
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


def _split_both(loss, ok, gamma, lf, split):
    out = []
    for impl in ("sort", "topk"):
        k = SimpleNamespace(lf=lf, split=split, split_impl=impl)
        below, above = tpe._TpeKernel._split(
            k, torch.as_tensor(loss, dtype=torch.float32),
            torch.as_tensor(ok), gamma)
        out.append((below.numpy(), above.numpy()))
    kj = SimpleNamespace(lf=lf, split=split, split_impl="sort")
    bj, aj = tpe_j._TpeKernel._split(kj, jnp.asarray(loss, jnp.float32),
                                     jnp.asarray(ok), gamma)
    out.append((np.asarray(bj), np.asarray(aj)))
    return out


@pytest.mark.parametrize("split", ["sqrt", "quantile"])
@pytest.mark.parametrize("seed", range(4))
def test_sort_split_parity_random_with_ties(split, seed):
    rng = np.random.default_rng(seed)
    n_cap = 64
    n_ok = int(rng.integers(1, n_cap))
    loss = np.full(n_cap, np.inf, np.float32)
    loss[:n_ok] = rng.integers(0, 6, n_ok).astype(np.float32)
    loss[rng.integers(0, n_ok, 2)] = np.nan
    ok = np.zeros(n_cap, bool)
    ok[:n_ok] = True
    for gamma in (0.15, 0.25, 0.9):
        for lf in (3, 25, 100):
            (b0, a0), (b1, a1), (bj, aj) = _split_both(loss, ok, gamma, lf,
                                                       split)
            np.testing.assert_array_equal(b0, b1)
            np.testing.assert_array_equal(a0, a1)
            np.testing.assert_array_equal(b0, bj)
            np.testing.assert_array_equal(a0, aj)
            assert not np.any(b0 & a0)
            assert np.array_equal(b0 | a0, ok)


def test_sort_split_below_is_the_k_smallest():
    loss = np.asarray([5, 1, 3, 2, 4, np.inf, np.inf], np.float32)
    ok = np.asarray([1, 1, 1, 1, 1, 0, 0], bool)
    (b0, _), (b1, _), (bj, _) = _split_both(loss, ok, 0.5, 25, "quantile")
    np.testing.assert_array_equal(b0, np.asarray([0, 1, 1, 1, 0, 0, 0],
                                                 bool))
    np.testing.assert_array_equal(b0, b1)
    np.testing.assert_array_equal(b0, bj)


def test_sort_split_over_lanes():
    """Lanes of the sort split equal their solo splits."""
    rng = np.random.default_rng(5)
    loss = rng.integers(0, 4, (3, 32)).astype(np.float32)
    ok = rng.random((3, 32)) < 0.8
    k = SimpleNamespace(lf=25, split="sqrt", split_impl="sort")
    b, a = tpe._TpeKernel._split(k, torch.as_tensor(loss),
                                 torch.as_tensor(ok), 0.25)
    for j in range(3):
        bj, aj = tpe._TpeKernel._split(k, torch.as_tensor(loss[j]),
                                       torch.as_tensor(ok[j]), 0.25)
        assert torch.equal(b[j], bj) and torch.equal(a[j], aj)


@pytest.mark.parametrize("seed", range(2))
def test_unfused_fit_equals_fused_and_jax_unfused(monkeypatch, seed):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    monkeypatch.setenv("HYPEROPT_TPU_FUSED_STEP", "0")
    csj, cst = compile_j(flagship(hj)), compile_t(flagship(ht))
    hist = tpe_j._padded_history(_history(csj, 50, seed), N_CAP)
    kj = tpe_j.get_kernel(csj, N_CAP, N_CAND, 25)
    assert not kj.fused_step
    fused = tpe.get_kernel(cst, N_CAP, N_CAND, 25, device=CPU)
    unfused = tpe.get_kernel(cst, N_CAP, N_CAND, 25, device=CPU,
                             fused_step=False)
    h = [torch.as_tensor(a) for a in hist]
    below, above = fused._split(h[2], h[3], 0.25)
    for gt in fused._gt:
        for pw in (1.0, torch.as_tensor([0.5], dtype=torch.float32)):
            lanes = [x[None] for x in h[:2]] if isinstance(pw, torch.Tensor) \
                else h[:2]
            bl, ab = ((below[None], above[None])
                      if isinstance(pw, torch.Tensor) else (below, above))
            a = fused._cont_fit(gt, *lanes, bl, ab, pw)
            b = unfused._cont_fit(gt, *lanes, bl, ab, pw)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    key = jax.random.key(900 + seed)
    want, _ = kj._fn(key, *(jnp.asarray(a) for a in hist), np.float32(0.25),
                     np.float32(1.0))
    noise = _jax_step_uniforms(key, kj)
    got, _ = unfused(*h, 0.25, 1.0, noise=noise)
    got_f, _ = fused(*h, 0.25, 1.0, noise=noise)
    assert torch.equal(got, got_f)
    _rows_agree(cst, got.numpy(), np.asarray(want))


def test_lowerings_are_validated():
    cs = compile_t(flagship(ht))
    for kw, name in ((dict(comp_sampler="normal"), "comp_sampler"),
                     (dict(split_impl="radix"), "split_impl"),
                     (dict(fused_step="yes"), "fused_step")):
        with pytest.raises(ValueError, match=name):
            tpe.get_kernel(cs, 32, 8, 25, device=CPU, **kw)


FLEET_SPACE = {"x": ht.hp.uniform("x", -5, 5),
               "n": ht.hp.qnormal("n", 0, 4, 1),
               "c": ht.hp.choice("c", [0, 1, 2, 3])}


def fleet_obj(p):
    return torch.abs(p["x"] - 1.0) + p["c"] + 0.1 * torch.abs(p["n"])


ALGO = dict(n_EI_candidates=16, n_startup_jobs=6)


@pytest.mark.parametrize("kw", [
    dict(comp_sampler="gumbel"),
    dict(comp_sampler="gumbel", multivariate=True),
    dict(split_impl="sort"),
    dict(fused_step=False),
], ids=["gumbel", "gumbel_mv", "sort", "unfused"])
def test_fleet_lanes_equal_solo_runs(kw):
    n = 20
    infos = fleet.fmin_fleet(fleet_obj, FLEET_SPACE, n_lanes=3, max_evals=n,
                             seed=8, device=CPU, **ALGO, **kw)
    for j, info in enumerate(infos):
        _, solo = ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=n,
                                 seed=8 + j, device=CPU, **ALGO, **kw)
        np.testing.assert_array_equal(info["losses"], solo["losses"])
        np.testing.assert_array_equal(info["vals"], solo["vals"])


@pytest.mark.parametrize("kw", [dict(split_impl="sort"),
                                dict(fused_step=False)],
                         ids=["sort", "unfused"])
def test_sort_and_unfused_land_the_default_trials(kw):
    """Device mode and the hosted loop: the same trials as the defaults."""
    _, base = ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=24, seed=2,
                             device=CPU, **ALGO)
    _, other = ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=24, seed=2,
                              device=CPU, **ALGO, **kw)
    np.testing.assert_array_equal(base["vals"], other["vals"])
    runs = []
    for extra in ({}, kw):
        t = ht.Trials()
        ht.fmin(lambda d: abs(d["x"] - 1.0) + d["c"], FLEET_SPACE,
                algo=partial(tpe.suggest, **ALGO, **extra), max_evals=16,
                trials=t, rstate=np.random.default_rng(1),
                show_progressbar=False, device=CPU)
        runs.append([d["misc"]["vals"] for d in t._dynamic_trials])
    assert runs[0] == runs[1]


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
