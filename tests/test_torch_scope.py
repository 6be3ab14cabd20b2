"""``scope`` expressions, the ``pyll`` shim and the space's classic views in
the port, against the JAX package.

Case for case the port's run of ``tests/test_scope.py`` with
``device="cpu"``.  Where a case computes a value (``space_eval`` through
scope ops, switch conditions, ``rec_eval`` with a memo or a seeded numpy
``rng``, ``dfs``/``toposort``, ``clone``, ``clone_merge``,
``use_obj_for_literal_in_memo``) both packages get the same expression,
built with their own ``hp``/``scope``, and the results must be equal
(exactly: the values are host Python numbers).  After those, the space's
classic views: ``expr_to_config`` equal to JAX's on every ``tests/zoo.py``
space, the 50-dim flagship space and the case of ``tests/test_pool.py``;
``CompiledSpace.active_path_pids`` equal on seeded points of seeded random
spaces; ``ParamSpec.is_categorical_like`` equal on every kind.

Already held elsewhere, and not repeated here: ``rec_eval``, ``dfs``,
``clone`` and ``clone_merge`` on one mixed expression
(``tests/test_torch_space_tools.py::test_pyll_rec_eval_dfs_and_clone_match_jax``,
``test_pyll_clone_merge_and_literal_memo_match_jax``), and the Graphviz
text of a scoped space equal to JAX's (``test_graphviz_dot_text_equals_jax``).
"""

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ho
from hyperopt_tpu import pyll as pyll_j
from hyperopt_tpu.space import expr_to_config as expr_to_config_j
from hyperopt_tpu_torch import hp, pyll, scope, space_eval
from hyperopt_tpu_torch.exceptions import InvalidAnnotatedParameter
from hyperopt_tpu_torch.space import compile_space, expr_to_config, \
    make_generator
from zoo import ZOO as ZOO_J
from zoo_torch import ZOO as ZOO_T


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class TestScopeBasics:
    def test_int_cast(self):
        space = {"n": scope.int(hp.quniform("n", 1, 64, 1))}
        cs = compile_space(space)
        vals, active = cs.sample(50, generator=make_generator("cpu", 0),
                                 device="cpu")
        for row in vals.numpy():
            cfg = cs.decode_row(row)
            assert isinstance(cfg["n"], int)
            assert 1 <= cfg["n"] <= 64
            assert cfg == hj.compile_space(
                {"n": hj.scope.int(hj.hp.quniform("n", 1, 64, 1))}
            ).decode_row(row)

    def test_arithmetic_overloads(self):
        for pkg in (ho, hj):
            cfg = pkg.space_eval(
                {"lr": pkg.hp.uniform("x", 0.0, 1.0) * 10.0 + 1.0},
                {"x": 0.5})
            assert cfg["lr"] == pytest.approx(6.0)
            cfg = pkg.space_eval({"y": -pkg.hp.uniform("x", 0, 1) ** 2 / 4},
                                 {"x": 0.5})
            assert cfg["y"] == pytest.approx(-0.0625)

        def build(pkg):
            x = pkg.hp.uniform("x", 0, 1)
            return {"y": abs((x - 0.5) * 3 // 0.25 % 2 - 1) ** 1.5 / 2}

        for x in np.random.default_rng(0).uniform(0, 1, 8):
            assert space_eval(build(ho), {"x": float(x)}) == \
                hj.space_eval(build(hj), {"x": float(x)})

    def test_named_ops(self):
        def build(pkg):
            return {
                "e": pkg.scope.exp(pkg.hp.uniform("a", -1, 1)),
                "m": pkg.scope.max(pkg.hp.uniform("b", 0, 1), 0.25),
                "g": pkg.scope.getitem([10, 20, 30], pkg.hp.randint("i", 3)),
            }

        point = {"a": 0.0, "b": 0.1, "i": 2}
        cfg = space_eval(build(ho), point)
        assert cfg["e"] == pytest.approx(1.0)
        assert cfg["m"] == 0.25
        assert cfg["g"] == 30
        assert cfg == hj.space_eval(build(hj), point)

    def test_unknown_op_raises(self):
        with pytest.raises(AttributeError):
            scope.not_a_real_op

    def test_define_custom_op(self):
        @scope.define
        def _test_double_it(x):
            return 2 * x

        cfg = space_eval({"d": _test_double_it(hp.uniform("x", 0, 1))},
                         {"x": 0.3})
        assert cfg["d"] == pytest.approx(0.6)
        cfg = space_eval({"d": scope._test_double_it(4)}, {})
        assert cfg["d"] == 8


class TestSwitch:
    def test_switch_on_randint_has_conditions(self):
        def build(pkg):
            hp_, scope_ = pkg.hp, pkg.scope
            return scope_.switch(
                hp_.randint("which", 3),
                {"kind": "a", "lr": hp_.loguniform("lr", -5, 0)},
                {"kind": "b"},
                {"kind": "c", "n": hp_.uniformint("n", 1, 8)})

        space = build(ho)
        cs = compile_space(space)
        assert cs.by_label["lr"].conditions == ((cs.by_label["which"].pid, 0),)
        assert cs.by_label["n"].conditions == ((cs.by_label["which"].pid, 2),)
        cs_j = hj.compile_space(build(hj))
        assert [p.conditions for p in cs.params] == \
            [p.conditions for p in cs_j.params]
        cfg = space_eval(space, {"which": 2, "n": 4})
        assert cfg == {"kind": "c", "n": 4}

    def test_switch_on_expression_index(self):
        space = scope.switch(scope.int(hp.quniform("s", 0, 1, 1)),
                             "off", "on")
        assert space_eval(space, {"s": 0.0}) == "off"
        assert space_eval(space, {"s": 1.0}) == "on"
        assert compile_space(space).params[0].conditions == ()

    def test_switch_arity_mismatch(self):
        with pytest.raises(InvalidAnnotatedParameter):
            compile_space(scope.switch(hp.randint("i", 3), "a", "b"))


class TestEndToEnd:
    def test_tpe_through_scoped_space(self):
        space = {"n": scope.int(hp.quniform("n", 1, 64, 1)),
                 "lr": scope.exp(hp.uniform("loglr", -6, 0))}
        seen_types = set()

        def objective(cfg):
            seen_types.add(type(cfg["n"]))
            return (cfg["n"] - 17) ** 2 + cfg["lr"]

        t = ho.Trials()
        ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=40,
                trials=t, rstate=np.random.default_rng(0),
                show_progressbar=False, device="cpu")
        assert seen_types == {int}
        assert t.best_trial["result"]["loss"] < 100.0
        assert 1.0 <= t.trials[0]["misc"]["vals"]["n"][0] <= 64.0

    def test_switch_under_fmin(self):
        space = {"branch": scope.switch(
            hp.randint("b", 2),
            {"act": "relu", "w": hp.uniform("w1", 0, 1)},
            {"act": "tanh", "w": hp.uniform("w2", 1, 2)})}

        def objective(cfg):
            return cfg["branch"]["w"]

        t = ho.Trials()
        best = ho.fmin(objective, space, algo=ho.rand.suggest, max_evals=30,
                       trials=t, rstate=np.random.default_rng(0),
                       show_progressbar=False, device="cpu")
        assert t.best_trial["result"]["loss"] < 0.2
        assert best["b"] == 0

    def test_pyll_shim_sample(self):
        def build(pkg):
            return {"n": pkg.scope.int(pkg.hp.quniform("n", 1, 8, 1)),
                    "c": pkg.hp.choice("c", ["x", "y"])}

        cfg = pyll.stochastic.sample(build(ho),
                                     rng=np.random.default_rng(0))
        assert isinstance(cfg["n"], int) and cfg["c"] in ("x", "y")

    def test_graphviz_renders_apply(self):
        from hyperopt_tpu_torch.graphviz import dot_hyperparameters

        dot = dot_hyperparameters(
            {"n": scope.int(hp.quniform("n", 1, 64, 1)),
             "s": scope.switch(scope.int(hp.quniform("i", 0, 1, 1)),
                               "a", "b")})
        assert "scope.int" in dot and "switch" in dot


class TestPyllImportIdioms:
    def test_reference_import_paths(self):
        from hyperopt_tpu_torch.pyll import as_apply, scope as s2, stochastic

        space = {"x": hp.uniform("px", 0, 1)}
        assert as_apply(space) is space
        assert s2 is scope
        cfg = stochastic.sample(space, seed=0)
        assert 0.0 <= cfg["x"] <= 1.0


class TestPyllInterpreter:
    def test_rec_eval_memo_by_label_and_node(self):
        x = hp.uniform("x", 0, 10)
        expr = x * 2 + 1
        assert pyll.rec_eval(expr, memo={"x": 3.0}) == 7.0
        assert pyll.rec_eval(expr, memo={x: 4.0}) == 9.0
        xj = hj.hp.uniform("x", 0, 10)
        for v in np.random.default_rng(1).uniform(0, 10, 6):
            assert pyll.rec_eval(expr, memo={"x": float(v)}) == \
                pyll_j.rec_eval(xj * 2 + 1, memo={"x": float(v)})

    def test_rec_eval_switch_is_lazy(self):
        bad = scope.int(hp.uniform("bad", 0, 1))
        expr = scope.switch(hp.randint("i", 2), "ok", bad)
        assert pyll.rec_eval(expr, memo={"i": 0}) == "ok"
        assert pyll.rec_eval(expr, memo={"i": 1, "bad": 0.7}) == 0

    def test_rec_eval_memo_never_substitutes_plain_literals(self):
        c = hp.choice("c", ["a", "b", "c", "d"])
        assert pyll.rec_eval(c, memo={"c": 2}) == "c"
        assert pyll.rec_eval({"lr": "x", "m": c},
                             memo={"c": 0, "lr": 99}) == \
            {"lr": "x", "m": "a"}

    def test_rec_eval_choice_memo_holds_branch_index(self):
        def build(pkg):
            return {"m": pkg.hp.choice(
                "c", [{"lr": pkg.hp.uniform("lr_a", 0, 1)},
                      {"lr": pkg.hp.uniform("lr_b", 1, 2)}])}

        memo = {"c": 1, "lr_b": 1.5}
        out = pyll.rec_eval(build(ho), memo=memo)
        assert out == {"m": {"lr": 1.5}}
        assert out == pyll_j.rec_eval(build(hj), memo=memo)

    def test_rec_eval_rng_draws_uncovered_leaves(self):
        def build(pkg):
            hp_ = pkg.hp
            return {"u": hp_.uniform("u", 0, 1),
                    "q": hp_.quniform("q", 0, 10, 2),
                    "c": hp_.choice("c", ["a", "b"]),
                    "n": pkg.scope.int(hp_.uniformint("n", 1, 4))}

        space, space_j = build(ho), build(hj)
        rng, rng_j = np.random.default_rng(0), np.random.default_rng(0)
        for _ in range(20):
            cfg = pyll.rec_eval(space, rng=rng)
            assert 0 <= cfg["u"] <= 1
            assert cfg["q"] % 2 == 0 and 0 <= cfg["q"] <= 10
            assert cfg["c"] in ("a", "b")
            assert cfg["n"] in (1, 2, 3, 4)
            assert cfg == pyll_j.rec_eval(space_j, rng=rng_j)
        with pytest.raises(KeyError):
            pyll.rec_eval(space)

    def test_dfs_toposort_order(self):
        x = hp.uniform("x", 0, 1)
        y = hp.uniform("y", 0, 1)
        expr = x * 2 + y
        nodes = pyll.dfs({"e": expr})
        assert nodes == pyll.toposort({"e": expr})
        pos = {id(n): i for i, n in enumerate(nodes)}
        for node in nodes:
            if isinstance(node, pyll.Apply):
                for a in node.args:
                    if isinstance(a, pyll.Expr):
                        assert pos[id(a)] < pos[id(node)]
        assert sum(isinstance(n, pyll.Param) for n in nodes) == 2
        shared = x + 1
        both = pyll.dfs([shared * 2, shared * 3])
        assert sum(1 for n in both if n is shared) == 1
        xj, yj = hj.hp.uniform("x", 0, 1), hj.hp.uniform("y", 0, 1)
        kinds = [type(n).__name__ for n in nodes]
        assert kinds == [type(n).__name__
                         for n in pyll_j.dfs({"e": xj * 2 + yj})]

    def test_clone_substitutes_and_preserves_sharing(self):
        x = hp.uniform("x", 0, 1)
        shared = x * 2
        expr = {"a": shared + 1, "b": shared + 2}
        cp = pyll.clone(expr)
        assert cp is not expr
        assert pyll.rec_eval(cp, memo={"x": 1.0}) == {"a": 3.0, "b": 4.0}
        nodes = [n for n in pyll.dfs(cp)
                 if isinstance(n, pyll.Apply) and n.op == "mul"]
        assert len(nodes) == 1
        cp2 = pyll.clone(expr, memo={x: pyll.Literal(5.0)})
        assert pyll.rec_eval(cp2) == {"a": 11.0, "b": 12.0}
        assert pyll.rec_eval(expr, memo={"x": 0.0}) == {"a": 1.0, "b": 2.0}

    def test_clone_result_still_compiles_and_optimizes(self):
        space = {"lr": hp.loguniform("lr", -3, 0),
                 "arch": hp.choice("arch", ["s", "m"])}
        clone = pyll.clone(space)
        t = ho.Trials()
        ho.fmin(lambda d: d["lr"], clone, algo=ho.rand.suggest, max_evals=10,
                trials=t, rstate=np.random.default_rng(0),
                show_progressbar=False, device="cpu")
        assert len(t) == 10

    def test_clone_merge_collapses_common_subexpressions(self):
        x = hp.uniform("x", 0, 1)
        expr = {"a": (x + 1) * 2, "b": (x + 1) * 3}
        merged = pyll.clone_merge(expr)
        adds = [n for n in pyll.dfs(merged)
                if isinstance(n, pyll.Apply) and n.op == "add"]
        assert len(adds) == 1
        assert pyll.rec_eval(merged, memo={"x": 1.0}) == {"a": 4.0,
                                                          "b": 6.0}
        assert pyll.rec_eval(expr, memo={"x": 0.0}) == {"a": 2.0,
                                                        "b": 3.0}
        orig_adds = [n for n in pyll.dfs(expr)
                     if isinstance(n, pyll.Apply) and n.op == "add"]
        assert len(orig_adds) == 2
        xj = hj.hp.uniform("x", 0, 1)
        merged_j = pyll_j.clone_merge({"a": (xj + 1) * 2, "b": (xj + 1) * 3})
        assert len(pyll.dfs(merged)) == len(pyll_j.dfs(merged_j))

    def test_clone_merge_literals_opt_in_and_memo(self):
        x = hp.uniform("x", 0, 1)
        expr = {"a": x + pyll.Literal(7.0), "b": x * pyll.Literal(7.0)}

        def lits(e):
            return [n for n in pyll.dfs(e)
                    if isinstance(n, pyll.Literal) and n.obj == 7.0]

        assert len(lits(pyll.clone_merge(expr))) == 2
        assert len(lits(pyll.clone_merge(expr, merge_literals=True))) == 1
        sub = pyll.clone_merge(expr, memo={x: pyll.Literal(2.0)})
        assert pyll.rec_eval(sub) == {"a": 9.0, "b": 14.0}

    def test_use_obj_for_literal_in_memo(self):
        sentinel = "__ctrl__"
        lit_a, lit_b = pyll.Literal(sentinel), pyll.Literal(sentinel)
        expr = {"u": hp.uniform("u", 0, 1), "c": lit_a, "d": lit_b}
        live = {"attachments": 42}
        memo = pyll.use_obj_for_literal_in_memo(expr, live, sentinel, {})
        assert memo == {lit_a: live, lit_b: live}
        out = pyll.rec_eval(expr, memo=dict(memo, **{"u": 0.25}))
        assert out == {"u": 0.25, "c": live, "d": live}
        memo2 = pyll.use_obj_for_literal_in_memo(expr, live, sentinel,
                                                 {lit_a: "kept"})
        assert memo2[lit_a] == "kept" and memo2[lit_b] is live
        assert pyll.use_obj_for_literal_in_memo(expr, live, "other",
                                                {}) == {}


# -- the space's classic views ----------------------------------------------


def flagship(pkg, n_dims=50):
    """The 50-dim mixed space of the north-star benchmark (``chip_smoke``)."""
    hp_ = pkg.hp
    space = {}
    for i in range(n_dims // 5):
        space[f"u{i}"] = hp_.uniform(f"u{i}", -5.0, 5.0)
        space[f"lu{i}"] = hp_.loguniform(f"lu{i}", -4.0, 2.0)
        space[f"q{i}"] = hp_.quniform(f"q{i}", 0.0, 20.0, 2.0)
        space[f"n{i}"] = hp_.normal(f"n{i}", 0.0, 2.0)
        space[f"c{i}"] = hp_.choice(f"c{i}", [0, 1, 2, 3])
    space["branch"] = hp_.choice("branch", [
        {"kind": "a", "lr": hp_.loguniform("lr", -6.0, 0.0)},
        {"kind": "b", "depth": hp_.uniformint("depth", 1, 8)},
    ])
    return space


def random_space(pkg, rng, depth=0, counter=None):
    """A seeded random nested space (``tests/test_space.py::_random_space``
    with the package's ``hp``/``scope``)."""
    hp_ = pkg.hp
    if counter is None:
        counter = [0]

    def fresh():
        counter[0] += 1
        return f"p{counter[0]}"

    roll = rng.random()
    if depth >= 3 or roll < 0.35:
        label = fresh()
        kind = rng.integers(0, 6)
        if kind == 0:
            return hp_.uniform(label, -5, 5)
        if kind == 1:
            return hp_.loguniform(label, -3, 2)
        if kind == 2:
            return hp_.quniform(label, 0, 20, 2)
        if kind == 3:
            return hp_.normal(label, 0, 2)
        if kind == 4:
            return hp_.randint(label, 7)
        return hp_.uniformint(label, 1, 9)
    if roll < 0.5:
        return pkg.scope.int(hp_.quniform(fresh(), 1, 32, 1))
    if roll < 0.65:
        n = int(rng.integers(2, 4))
        return hp_.choice(fresh(), [
            random_space(pkg, rng, depth + 1, counter) for _ in range(n)])
    if roll < 0.8:
        return {f"k{i}": random_space(pkg, rng, depth + 1, counter)
                for i in range(rng.integers(1, 4))}
    if roll < 0.9:
        return [random_space(pkg, rng, depth + 1, counter)
                for _ in range(rng.integers(1, 3))]
    return (42, random_space(pkg, rng, depth + 1, counter))


@pytest.mark.parametrize("name", sorted(ZOO_J))
def test_expr_to_config_equals_jax_on_the_zoo(name):
    assert expr_to_config(ZOO_T[name].space) == \
        expr_to_config_j(ZOO_J[name].space)


def test_expr_to_config_equals_jax_on_the_flagship_space():
    got = expr_to_config(flagship(ho))
    assert len(got) == 53
    assert got == expr_to_config_j(flagship(hj))


def test_expr_to_config_reports_dists_and_conditions():
    def build(pkg):
        return {"x": pkg.hp.uniform("x", -5, 5),
                "c": pkg.hp.choice("c", [
                    {"lr": pkg.hp.loguniform("lr", -4, 0)}, {}])}

    cfg = expr_to_config(build(ho))
    assert cfg["x"]["dist"] == "uniform"
    assert cfg["x"]["args"] == {"low": -5.0, "high": 5.0}
    assert cfg["x"]["conditions"] == ()
    assert cfg["c"]["dist"] == "categorical"
    assert cfg["c"]["args"]["upper"] == 2
    assert cfg["lr"]["conditions"] == (("c", 0),)
    assert cfg == expr_to_config_j(build(hj))


@pytest.mark.parametrize("seed", range(6))
def test_active_path_pids_equal_jax(seed):
    """Seeded random spaces; points with every label, with the labels of
    one branch dropped, and with gating values out of any branch."""
    space_t = random_space(ho, np.random.default_rng(seed))
    space_j = random_space(hj, np.random.default_rng(seed))
    cs, cs_j = compile_space(space_t), hj.compile_space(space_j)
    rng = np.random.default_rng(100 + seed)
    vals, _ = cs.sample(8, generator=make_generator("cpu", seed),
                        device="cpu")
    for row in vals.numpy():
        point = {p.label: row[p.pid] for p in cs.params}
        dropped = {k: v for k, v in point.items() if rng.random() < 0.7}
        listed = {k: [v] for k, v in point.items()}
        for pt in (point, dropped, listed):
            got = cs.active_path_pids(pt)
            assert got == cs_j.active_path_pids(pt)
            # The active path is the sampler's mask for that row.
            if pt is point:
                assert got == [int(p) for p in
                               np.flatnonzero(cs.active_mask_host(
                                   row[None])[0])]


def test_is_categorical_like_equals_jax():
    cs = compile_space(ZOO_T["many_dists"].space)
    cs_j = hj.compile_space(ZOO_J["many_dists"].space)
    got = {p.label: p.is_categorical_like for p in cs.params}
    assert got == {p.label: p.is_categorical_like for p in cs_j.params}
    assert got["b"] and got["a"] and got["k"] and not got["l"] \
        and not got["c"]
