"""The space tools of the PyTorch port against hyperopt_tpu: ``criteria``
(torch against ``jax.numpy``, float32 both: rtol 1e-5), and the host
modules ``rdists``, ``pyll`` (``pyll_shim``), ``graphviz``, ``plotting``
and ``utils``, which must give JAX's results exactly on the same inputs
(tolerance: none), with ``stochastic.sample`` the one exception (the port
draws from a ``torch.Generator``: in bounds, not equal).  The package's
names (``Apply``, the exceptions, ``fmin_pass_expr_memo_ctrl``, the
``pyll`` module alias) resolve as JAX's do.
"""

import sys

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import criteria as criteria_j
from hyperopt_tpu import graphviz as graphviz_j
from hyperopt_tpu import plotting as plotting_j
from hyperopt_tpu import pyll as pyll_j
from hyperopt_tpu import rdists as rdists_j
from hyperopt_tpu import utils as utils_j
from hyperopt_tpu_torch import criteria, graphviz, plotting, pyll, rdists
from hyperopt_tpu_torch import utils

CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- criteria -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["EI_gaussian", "logEI_gaussian", "UCB"])
def test_criteria_match_jax(name):
    rng = np.random.default_rng(0)
    mean = rng.normal(0, 3, 400).astype(np.float32)
    var = rng.uniform(0.01, 4.0, 400).astype(np.float32)
    # Scores from deep in the negative tail to far positive.
    thresh = np.float32(1.5) if name != "UCB" else np.float32(2.0)
    mean[:20] = np.linspace(-60, -5, 20, dtype=np.float32)
    want = np.asarray(getattr(criteria_j, name)(mean, var, thresh))
    got = getattr(criteria, name)(mean, var, thresh)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if name == "logEI_gaussian":
        assert np.isfinite(got.numpy()).all()


def test_ei_empirical_matches_jax():
    s = np.random.default_rng(1).normal(0, 1, 1000).astype(np.float32)
    want = float(criteria_j.EI_empirical(s, 0.3))
    got = float(criteria.EI_empirical(s, 0.3))
    assert got == pytest.approx(want, rel=1e-5)
    t = torch.as_tensor(s, dtype=torch.float64)
    assert criteria.EI_gaussian(t, t * t + 1, 0.0).dtype == torch.float64


# -- rdists -------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("loguniform_gen", (-2.0, 1.5)),
    ("lognorm_gen", (0.3, 0.8)),
    ("quniform_gen", (0.0, 10.0, 2.5)),
    ("qloguniform_gen", (0.0, 3.0, 1.0)),
    ("qnormal_gen", (1.0, 3.0, 0.5)),
    ("qlognormal_gen", (0.0, 1.0, 0.5)),
    ("uniformint_gen", (-3, 4)),
])
def test_rdists_equal_jax(name, args):
    dj, dt = getattr(rdists_j, name)(*args), getattr(rdists, name)(*args)
    np.testing.assert_array_equal(dt.rvs(size=300, random_state=7),
                                  dj.rvs(size=300, random_state=7))
    x = np.linspace(-4, 25, 117)
    for fn in ("pdf", "cdf", "pmf"):
        if hasattr(dj, fn):
            np.testing.assert_array_equal(getattr(dt, fn)(x),
                                          getattr(dj, fn)(x))
    if hasattr(dj, "support_lattice"):
        np.testing.assert_array_equal(dt.support_lattice(-1, 7),
                                      dj.support_lattice(-1, 7))


# -- pyll ---------------------------------------------------------------------


def _expr(pkg):
    hp, scope = pkg.hp, pkg.scope
    x = hp.uniform("x", 0, 10)
    shared = x * 2
    return {"a": shared + 1, "b": shared + scope.int(hp.quniform("q", 0, 8, 2)),
            "m": hp.choice("m", [{"lr": hp.uniform("lr_a", 0, 1)},
                                 {"lr": hp.uniform("lr_b", 1, 2)}]),
            "s": scope.switch(hp.randint("i", 2), "ok",
                              scope.int(hp.uniform("bad", 0, 1)))}


def _shape(nodes):
    """A package-neutral view of a node list: kinds, labels and ops."""
    out = []
    for n in nodes:
        out.append((type(n).__name__, getattr(n, "label", None),
                    getattr(n, "op", None)))
    return out


def test_pyll_rec_eval_dfs_and_clone_match_jax():
    ej, et = _expr(hj), _expr(ht)
    memo = {"x": 3.0, "q": 4.0, "m": 1, "lr_b": 1.5, "i": 0}
    assert pyll.rec_eval(et, memo=memo) == pyll_j.rec_eval(ej, memo=memo)
    assert pyll.rec_eval(et, memo=dict(memo, i=1, bad=0.7)) == \
        pyll_j.rec_eval(ej, memo=dict(memo, i=1, bad=0.7))
    assert _shape(pyll.dfs(et)) == _shape(pyll_j.dfs(ej))
    assert _shape(pyll.toposort(et)) == _shape(pyll_j.toposort(ej))
    cj, ct = pyll_j.clone(ej), pyll.clone(et)
    assert _shape(pyll.dfs(ct)) == _shape(pyll_j.dfs(cj))
    assert pyll.rec_eval(ct, memo=memo) == pyll_j.rec_eval(cj, memo=memo)
    with pytest.raises(KeyError):
        pyll.rec_eval(et)


def test_pyll_clone_merge_and_literal_memo_match_jax():
    def build(pkg, lit):
        x = pkg.hp.uniform("x", 0, 1)
        return [lit(7), (x + 1) * 2, (x + 1) * 3, lit(7)]

    ej = build(hj, pyll_j.Literal)
    et = build(ht, pyll.Literal)
    for kw in ({}, {"merge_literals": True}):
        mj, mt = pyll_j.clone_merge(ej, **kw), pyll.clone_merge(et, **kw)
        assert _shape(pyll.dfs(mt)) == _shape(pyll_j.dfs(mj))
        assert len(pyll.dfs(mt)) == len(pyll_j.dfs(mj))
    memo_j = pyll_j.use_obj_for_literal_in_memo(ej, "ctrl", 7, {})
    memo_t = pyll.use_obj_for_literal_in_memo(et, "ctrl", 7, {})
    assert sorted(memo_t.values()) == sorted(memo_j.values())
    assert pyll.rec_eval(et, memo=dict(memo_t, x=0.5)) == \
        pyll_j.rec_eval(ej, memo=dict(memo_j, x=0.5))
    assert pyll.as_apply(et) is et


def test_pyll_stochastic_sample_and_module_alias():
    from hyperopt_tpu_torch.pyll import scope as s2, stochastic

    assert s2 is ht.scope and sys.modules["hyperopt_tpu_torch.pyll"] is pyll
    space = {"x": ht.hp.uniform("x", 0, 1),
             "c": ht.hp.choice("c", [{"k": 0},
                                     {"k": 1, "n": ht.hp.randint("n", 5)}])}
    for seed in range(10):
        cfg = stochastic.sample(space, seed=seed)
        assert 0.0 <= cfg["x"] <= 1.0
        assert cfg["c"]["k"] in (0, 1)
        if cfg["c"]["k"] == 1:
            assert cfg["c"]["n"] in range(5)
    a = stochastic.sample(space, rng=np.random.default_rng(3))
    b = stochastic.sample(space, rng=np.random.default_rng(3))
    assert a == b


# -- graphviz -----------------------------------------------------------------


def _tool_space(pkg):
    hp, scope = pkg.hp, pkg.scope
    return {
        "curve": hp.choice("curve", [
            {"kind": "flat"},
            {"kind": "wave", "amp": hp.uniform("amp", 0.1, 2.0),
             "freq": hp.qloguniform("freq", 0.0, 3.0, 1.0)}]),
        "layers": [hp.quniform("l0", 1, 8, 1), hp.normal("w", 0, 2)],
        "pair": (scope.int(hp.uniformint("k", 1, 4)), "lit"),
        "sw": scope.switch(hp.randint("i", 2), 0.5, hp.lognormal("ln", 0, 1)),
    }


def test_graphviz_dot_text_equals_jax():
    got = graphviz.dot_hyperparameters(_tool_space(ht))
    assert got == graphviz_j.dot_hyperparameters(_tool_space(hj))
    assert got.startswith("digraph") and got.rstrip().endswith("}")


# -- plotting -----------------------------------------------------------------


def _ran_trials():
    def fn(d):
        amp = d["curve"].get("amp", 0.0)
        return float((d["layers"][1] - amp) ** 2 + d["layers"][0])

    runs = []
    for pkg, kw in ((hj, {}), (ht, {"device": CPU})):
        t = pkg.Trials()
        pkg.fmin(fn, _tool_space(pkg), algo=pkg.rand.suggest, max_evals=25,
                 trials=t, rstate=np.random.default_rng(0),
                 show_progressbar=False, **kw)
        runs.append(t)
    return runs


def _points(ax):
    return [np.asarray(c.get_offsets()).tolist() for c in ax.collections]


def test_plots_draw_jax_points():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    tj, tt = _ran_trials()
    # Random search: the two packages' trials differ; plot the JAX run's
    # docs with both modules (the port reads docs and the dense history).
    tt = ht.trials_from_docs(list(tj))
    try:
        for name in ("main_plot_history", "main_plot_histogram"):
            ax_t = getattr(plotting, name)(tt, do_show=False)
            ax_j = getattr(plotting_j, name)(tj, do_show=False)
            assert _points(ax_t) == _points(ax_j)
            assert [p.get_height() for p in ax_t.patches] == \
                [p.get_height() for p in ax_j.patches]
        axes_t = plotting.main_plot_vars(tt, space=_tool_space(ht),
                                         do_show=False)
        axes_j = plotting_j.main_plot_vars(tj, space=_tool_space(hj),
                                           do_show=False)
        assert axes_t.shape == axes_j.shape
        for at, aj in zip(axes_t.ravel(), axes_j.ravel()):
            assert at.get_title() == aj.get_title()
            assert _points(at) == _points(aj)
    finally:
        plt.close("all")


# -- utils and the package's names ---------------------------------------------


def test_utils_equal_jax():
    x, x_all = np.arange(10), np.asarray([2, 5, 7, 11])
    np.testing.assert_array_equal(utils.fast_isin(x, x_all),
                                  utils_j.fast_isin(x, x_all))
    docs = [{"tid": t, "version": v} for t, v in
            ((3, 0), (1, 0), (3, 2), (2, 1), (1, 4), (3, 1), (0, 0))]
    np.testing.assert_array_equal(utils.get_most_recent_inds(docs),
                                  utils_j.get_most_recent_inds(docs))


@pytest.mark.parametrize("name", [
    "Apply", "HyperoptTpuError", "InvalidTrial", "InjectedFault",
    "TransientEvaluationError", "fmin_pass_expr_memo_ctrl", "pyll", "qmc",
    "criteria", "rdists", "graphviz", "plotting"])
def test_package_names_resolve(name):
    obj = getattr(ht, name)
    assert name in ht.__all__
    assert type(obj).__name__ == type(getattr(hj, name)).__name__
    if isinstance(obj, type) and issubclass(obj, Exception):
        assert issubclass(obj, ht.HyperoptTpuError)
