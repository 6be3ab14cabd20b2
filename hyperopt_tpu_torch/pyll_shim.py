"""``pyll``-compat shim for code written against the reference's
``hyperopt.pyll``.

Counterpart of ``hyperopt_tpu/pyll_shim.py``: ``scope``,
``stochastic.sample(space, rng)`` (one concrete configuration), and the
graph-interpreter surface reference code uses for graph surgery:
``rec_eval`` (memoized lazy evaluator), ``dfs``/``toposort``, ``clone``,
``clone_merge``, ``use_obj_for_literal_in_memo``, ``Literal`` and
``as_apply``.  They work on this package's expression graph
(:class:`~hyperopt_tpu_torch.space.Expr` trees: ``Param``/``Choice``
leaves, ``Apply`` nodes, plain dict/list/tuple containers).  The hot path
never interprets: spaces compile once to a batched sampler
(:mod:`hyperopt_tpu_torch.space`).

Importable as ``hyperopt_tpu_torch.pyll``::

    from hyperopt_tpu_torch import pyll
    cfg = pyll.stochastic.sample(space, rng=np.random.default_rng(0))
    val = pyll.rec_eval(expr, memo={"x": 0.5})
"""

from __future__ import annotations

import numpy as np

from .scope import scope  # noqa: F401
from .space import (
    _SCOPE_IMPLS,
    CATEGORICAL,
    LOGNORMAL,
    LOGUNIFORM,
    NORMAL,
    QLOGNORMAL,
    QLOGUNIFORM,
    QNORMAL,
    QUNIFORM,
    RANDINT,
    UNIFORM,
    UNIFORMINT,
    Apply,
    Choice,
    Expr,
    Param,
    compile_space,
    make_generator,
)


class Literal(Expr):
    """A constant wrapped as a graph node (reference: ``pyll.Literal``).

    Plain Python values embedded in a space already act as literals; this
    class exists for reference code that constructs/inspects ``Literal``
    nodes explicitly (e.g. during ``clone``-based rewrites).
    """

    __slots__ = ("obj",)

    def __init__(self, obj=None):
        self.obj = obj

    def __repr__(self):
        return f"Literal({self.obj!r})"


def as_apply(obj):
    """Identity shim for the reference's ``pyll.as_apply``.

    Reference code wraps spaces with ``as_apply`` before handing them to
    hyperopt (``pyll/base.py::as_apply`` builds Apply/Literal nodes); here
    nested dict/list/``hp.*`` structures ARE the space representation and
    every entry point accepts them directly, so migration code calling
    ``pyll.as_apply(space)`` gets its input back unchanged.
    """
    return obj


# ---------------------------------------------------------------------------
# graph interpretation (reference: pyll/base.py::rec_eval ~L550-700)
# ---------------------------------------------------------------------------


def _memo_get(memo, node):
    """Memo lookup by node identity first (the reference's convention),
    then by label (the natural spelling for this framework's users)."""
    if memo is None:
        return False, None
    try:
        if node in memo:
            return True, memo[node]
    except TypeError:       # unhashable memo key types — label path below
        pass
    label = getattr(node, "label", None)
    if label is not None and label in memo:
        return True, memo[label]
    return False, None


def _draw_leaf(p: Param, rng: np.random.Generator):
    """One numpy draw from a stochastic leaf's marginal (the generative
    semantics ``pyll/stochastic.py``'s samplers implement per node)."""
    k = p.kind
    if k == UNIFORM:
        return float(rng.uniform(p.low, p.high))
    if k == LOGUNIFORM:
        return float(np.exp(rng.uniform(p.low, p.high)))
    if k == QUNIFORM:
        return float(np.round(rng.uniform(p.low, p.high) / p.q) * p.q)
    if k == QLOGUNIFORM:
        return float(np.round(np.exp(rng.uniform(p.low, p.high)) / p.q) * p.q)
    if k == NORMAL:
        return float(rng.normal(p.mu, p.sigma))
    if k == LOGNORMAL:
        return float(np.exp(rng.normal(p.mu, p.sigma)))
    if k == QNORMAL:
        return float(np.round(rng.normal(p.mu, p.sigma) / p.q) * p.q)
    if k == QLOGNORMAL:
        return float(np.round(np.exp(rng.normal(p.mu, p.sigma)) / p.q) * p.q)
    if k == RANDINT:
        if p.probs is not None:
            return int(p.low) + int(rng.choice(len(p.probs), p=p.probs))
        return int(rng.integers(p.low, p.high))
    if k == UNIFORMINT:
        return int(rng.integers(p.low, int(p.high) + 1))
    if k == CATEGORICAL:
        return int(rng.choice(len(p.probs), p=p.probs))
    raise ValueError(f"cannot draw from {p!r}")


def rec_eval(expr, memo=None, rng=None):
    """Evaluate an expression tree to a concrete value.

    Reference: ``pyll/base.py::rec_eval(expr, memo=...)`` — the memoized
    post-order interpreter.  ``memo`` maps nodes (by identity, the
    reference convention) or labels to concrete values; stochastic leaves
    not covered by the memo are drawn with ``rng`` (a
    ``numpy.random.Generator``) or raise.  ``scope.switch`` is lazy: only
    the selected branch is evaluated, exactly like the reference builtin.
    """

    def rec(node):
        if isinstance(node, Choice):
            # A memo entry for a Choice holds the BRANCH INDEX (the value
            # stored in trials' misc.vals), not the branch's final value.
            hit_i, idx = _memo_get(memo, node)
            if not hit_i:
                if rng is None:
                    raise KeyError(
                        f"rec_eval: no memo value (and no rng) for {node!r}")
                probs = node.probs or \
                    [1.0 / len(node.options)] * len(node.options)
                idx = int(rng.choice(len(node.options), p=probs))
            return rec(node.options[int(idx)])
        # The memo applies to GRAPH NODES only — a plain literal that
        # happens to equal a label key (e.g. option string "c" vs label
        # "c") must never be substituted.
        if isinstance(node, Expr):
            hit, v = _memo_get(memo, node)
            if hit:
                return v
        if isinstance(node, Literal):
            return node.obj
        if isinstance(node, Param):
            if rng is not None:
                return _draw_leaf(node, rng)
            raise KeyError(
                f"rec_eval: no memo value (and no rng) for {node!r}")
        if isinstance(node, Apply):
            if node.op == "switch":
                sel = int(rec(node.args[0]))
                options = node.args[1:]
                if not 0 <= sel < len(options):
                    raise IndexError(
                        f"scope.switch index {sel} out of range for "
                        f"{len(options)} options")
                return rec(options[sel])
            return _SCOPE_IMPLS[node.op](*(rec(a) for a in node.args))
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node      # plain literal

    return rec(expr)


def dfs(expr):
    """Post-order list of the UNIQUE graph nodes under ``expr`` (children
    before parents).  Reference: ``pyll/base.py::dfs``.  Only ``Expr``
    nodes are returned; container structure is traversed through."""
    seen: set = set()
    out: list = []

    def rec(node):
        if isinstance(node, Expr):
            if id(node) in seen:
                return
            seen.add(id(node))
            if isinstance(node, Apply):
                for a in node.args:
                    rec(a)
            elif isinstance(node, Choice):
                for o in node.options:
                    rec(o)
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                rec(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)

    rec(expr)
    return out


def toposort(expr):
    """Topological order of the expression DAG (every node after all of its
    inputs).  Reference: ``pyll/base.py::toposort`` (networkx there; the
    deduplicated post-order is the same ordering for these graphs)."""
    return dfs(expr)


def clone(expr, memo=None):
    """Deep-copy an expression graph, substituting via ``memo``
    (node → replacement).  Reference: ``pyll/base.py::clone`` — the graph-
    surgery primitive behind space rewrites.  Shared subgraphs stay shared
    in the copy (identity-memoized like the reference)."""
    memo = dict(memo or {})

    def rec(node):
        if isinstance(node, Expr):
            if id(node) in _copies:
                return _copies[id(node)]
            if memo:
                try:
                    if node in memo:
                        return memo[node]
                except TypeError:
                    pass
            if isinstance(node, Literal):
                new = Literal(node.obj)
            elif isinstance(node, Param):
                new = Param(node.label, node.kind, low=node.low,
                            high=node.high, mu=node.mu, sigma=node.sigma,
                            q=node.q, probs=node.probs)
            elif isinstance(node, Choice):
                new = Choice(node.label, [rec(o) for o in node.options],
                             probs=node.probs)
            elif isinstance(node, Apply):
                new = Apply(node.op, tuple(rec(a) for a in node.args))
            else:       # pragma: no cover - future Expr subclasses
                raise TypeError(f"clone: unknown node type {type(node)!r}")
            _copies[id(node)] = new
            return new
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    _copies: dict = {}
    return rec(expr)


def clone_merge(expr, memo=None, merge_literals=False):
    """Clone with common-subexpression merging.

    Reference: ``pyll/base.py::clone_merge`` — like :func:`clone`, but
    structurally identical nodes in the copy collapse onto one shared
    node (two ``scope.add(x, 1)`` applications of the same ``x`` become
    one).  ``merge_literals`` additionally merges equal-valued
    :class:`Literal` nodes (off by default, like the reference: literal
    identity can be load-bearing for memo-based substitution).  ``memo``
    pre-seeds node replacements exactly as in :func:`clone`.
    """
    memo = dict(memo or {})
    _copies: dict = {}
    _table: dict = {}

    def ckey(c):
        # Children are merged before parents, so structural equality of
        # Expr children has become object identity by the time a parent's
        # key is computed; plain values compare by value when hashable.
        if isinstance(c, Expr):
            return ("n", id(c))
        try:
            hash(c)
        except TypeError:
            return ("u", id(c))
        return ("v", type(c).__name__, c)

    def skey(new):
        if isinstance(new, Literal):
            if not merge_literals:
                return None
            try:
                hash(new.obj)
            except TypeError:
                return None
            return ("lit", type(new.obj).__name__, new.obj)
        if isinstance(new, Param):
            probs = None if new.probs is None else tuple(map(float,
                                                             new.probs))
            return ("param", new.label, new.kind, new.low, new.high,
                    new.mu, new.sigma, new.q, probs)
        if isinstance(new, Choice):
            probs = None if new.probs is None else tuple(map(float,
                                                             new.probs))
            return ("choice", new.label,
                    tuple(ckey(o) for o in new.options), probs)
        if isinstance(new, Apply):
            return ("apply", new.op, tuple(ckey(a) for a in new.args))
        return None

    def rec(node):
        if isinstance(node, Expr):
            if id(node) in _copies:
                return _copies[id(node)]
            if memo:
                try:
                    if node in memo:
                        return memo[node]
                except TypeError:
                    pass
            if isinstance(node, Literal):
                new = Literal(node.obj)
            elif isinstance(node, Param):
                new = Param(node.label, node.kind, low=node.low,
                            high=node.high, mu=node.mu, sigma=node.sigma,
                            q=node.q, probs=node.probs)
            elif isinstance(node, Choice):
                new = Choice(node.label, [rec(o) for o in node.options],
                             probs=node.probs)
            elif isinstance(node, Apply):
                new = Apply(node.op, tuple(rec(a) for a in node.args))
            else:       # pragma: no cover - future Expr subclasses
                raise TypeError(
                    f"clone_merge: unknown node type {type(node)!r}")
            k = skey(new)
            if k is not None:
                new = _table.setdefault(k, new)
            _copies[id(node)] = new
            return new
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    return rec(expr)


def use_obj_for_literal_in_memo(expr, obj, lit, memo):
    """Set ``memo[node] = obj`` for every ``Literal`` equal to ``lit``.

    Reference: ``pyll/base.py::use_obj_for_literal_in_memo`` — the idiom
    behind ``fmin_pass_expr_memo_ctrl`` objectives: plant a sentinel
    literal in the space, then substitute the live object (e.g. a
    ``Ctrl``) at evaluation time.  Existing memo entries are preserved;
    the (mutated) memo is returned for chaining.
    """
    for node in dfs(expr):
        if isinstance(node, Literal):
            try:
                match = node.obj == lit
            except Exception:
                match = False
            if match and node not in memo:
                memo[node] = obj
    return memo


class stochastic:
    """Namespace mirror of ``hyperopt.pyll.stochastic``."""

    @staticmethod
    def sample(space, rng=None, seed=None):
        """Draw one concrete configuration from ``space``: one batched draw
        (``n = 1``) on the CPU from a generator seeded by ``seed``, or by a
        draw from ``rng`` (a ``numpy.random.Generator`` or a legacy
        ``RandomState``), then a host decode."""
        if seed is None:
            if rng is None:
                seed = np.random.default_rng().integers(2 ** 31 - 1)
            elif isinstance(rng, np.random.Generator):
                seed = rng.integers(2 ** 31 - 1)
            else:
                seed = rng.randint(2 ** 31 - 1)
        cs = compile_space(space)
        gen = make_generator("cpu", int(seed) % (2 ** 32))
        vals, active = cs.sample(1, generator=gen, device="cpu")
        return cs.decode_row(vals[0].numpy(), active[0].numpy())
