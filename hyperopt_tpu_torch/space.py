"""Search-space specification and its compiler, in PyTorch.

Counterpart of ``hyperopt_tpu/space.py``.  A nested ``hp.*`` structure is
compiled once into a :class:`CompiledSpace`: a flat table of scalar
parameters (:class:`ParamSpec`) with a dense batched sampler

    ``sample(n, generator) -> (vals f32[n, P], active bool[n, P])``

and a host decoder back to the user's nested config.  Parameters under an
unchosen ``hp.choice`` branch are still drawn and masked out in ``active``.
Conditions are static ``(choice pid, branch)`` conjunctions per parameter.

Sampling is batched by family: one uniform draw per family, transformed
(``ndtri`` for the normal family, an inverse-CDF pick for categoricals,
``floor`` for wide randints).  The draws come from an explicit
``torch.Generator``, or are handed in as ``noise`` so that a test can give
both packages the same numbers.

A compiled space carries the ``device`` its suggest algorithms run on
(``fmin(device=...)`` sets it).  ``None`` means CUDA; see
:func:`resolve_device`.
"""

from __future__ import annotations

import math
import operator as _operator
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from .exceptions import DuplicateLabel, InvalidAnnotatedParameter
from .ops.gmm import icdf_pick

UNIFORM = "uniform"
LOGUNIFORM = "loguniform"
QUNIFORM = "quniform"
QLOGUNIFORM = "qloguniform"
NORMAL = "normal"
LOGNORMAL = "lognormal"
QNORMAL = "qnormal"
QLOGNORMAL = "qlognormal"
RANDINT = "randint"
UNIFORMINT = "uniformint"
CATEGORICAL = "categorical"

_UNIFORM_FAMILY = (UNIFORM, LOGUNIFORM, QUNIFORM, QLOGUNIFORM, UNIFORMINT)
_INT_KINDS = (RANDINT, UNIFORMINT, CATEGORICAL)
_LOG_KINDS = (LOGUNIFORM, QLOGUNIFORM, LOGNORMAL, QLOGNORMAL)
_Q_KINDS = (QUNIFORM, QLOGUNIFORM, QNORMAL, QLOGNORMAL)

# Widest hp.randint range representable exactly in the f32 vals matrix.
_MAX_RANDINT_RANGE = 2 ** 24
# Above this many options a randint is sampled by integer draw instead of
# per-option probabilities (TPE's categorical posterior needs the latter).
_DENSE_CAT_MAX = 1024
# Uniforms feeding ndtri are kept inside (0, 1).
_U_TINY = 1e-12
_U_MAX = 1.0 - 1e-7


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default)
    and there is none; there is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hyperopt_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def make_generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from an integer seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class Expr:
    """Base class for search-space expressions built by ``hp.*`` / ``scope``.

    Arithmetic builds deterministic :class:`Apply` nodes over the
    stochastic leaves: ``hp.uniform("x", 0, 1) * 10 + 1``.
    """

    __slots__ = ()

    def __add__(self, other):
        return Apply("add", (self, other))

    def __radd__(self, other):
        return Apply("add", (other, self))

    def __sub__(self, other):
        return Apply("sub", (self, other))

    def __rsub__(self, other):
        return Apply("sub", (other, self))

    def __mul__(self, other):
        return Apply("mul", (self, other))

    def __rmul__(self, other):
        return Apply("mul", (other, self))

    def __truediv__(self, other):
        return Apply("truediv", (self, other))

    def __rtruediv__(self, other):
        return Apply("truediv", (other, self))

    def __floordiv__(self, other):
        return Apply("floordiv", (self, other))

    def __rfloordiv__(self, other):
        return Apply("floordiv", (other, self))

    def __mod__(self, other):
        return Apply("mod", (self, other))

    def __pow__(self, other):
        return Apply("pow", (self, other))

    def __rpow__(self, other):
        return Apply("pow", (other, self))

    def __neg__(self):
        return Apply("neg", (self,))

    def __abs__(self):
        return Apply("abs", (self,))

    def __getitem__(self, item):
        return Apply("getitem", (self, item))

    def __iter__(self):
        # Without this, iteration would fall back to __getitem__(0), (1),
        # ... and never end.
        raise TypeError(
            f"{type(self).__name__} expressions are not iterable")

    __array_ufunc__ = None


class Apply(Expr):
    """A deterministic operation over sub-expressions, applied when a
    sampled row is decoded on the host (never on the suggest path)."""

    __slots__ = ("op", "args")

    def __init__(self, op: str, args: tuple):
        if op not in _SCOPE_IMPLS:
            raise InvalidAnnotatedParameter(
                f"unknown scope op {op!r}; register it with "
                f"hyperopt_tpu_torch.scope.define")
        self.op = op
        self.args = tuple(args)

    def __repr__(self):
        return f"scope.{self.op}({', '.join(map(repr, self.args))})"


# Host-side implementations of scope ops; extended by @scope.define.
_SCOPE_IMPLS = {
    "add": _operator.add,
    "sub": _operator.sub,
    "mul": _operator.mul,
    "truediv": _operator.truediv,
    "div": _operator.truediv,
    "floordiv": _operator.floordiv,
    "mod": _operator.mod,
    "pow": _operator.pow,
    "neg": _operator.neg,
    "abs": abs,
    "int": int,
    "float": float,
    "round": round,
    "log": math.log,
    "log2": math.log2,
    "log10": math.log10,
    "exp": math.exp,
    "sqrt": math.sqrt,
    "ceil": math.ceil,
    "floor": math.floor,
    "min": min,
    "max": max,
    "len": len,
    "getitem": _operator.getitem,
    "pos_args": lambda *a: tuple(a),
    # "switch" is structural (lazy branch selection), handled by the
    # compiler and decoder directly.
    "switch": None,
}


def define_op(name: str, fn) -> None:
    """Register a host-side implementation for a scope op."""
    if name in _SCOPE_IMPLS:
        raise ValueError(f"scope op {name!r} already defined")
    _SCOPE_IMPLS[name] = fn


class Param(Expr):
    """A single scalar hyperparameter with a named prior distribution."""

    __slots__ = ("label", "kind", "low", "high", "mu", "sigma", "q", "probs")

    def __init__(self, label, kind, low=None, high=None, mu=None, sigma=None,
                 q=None, probs=None):
        if not isinstance(label, str):
            raise TypeError(f"hyperparameter label must be a str, got {label!r}")
        self.label = label
        self.kind = kind
        self.low = low
        self.high = high
        self.mu = mu
        self.sigma = sigma
        self.q = q
        self.probs = probs

    def __repr__(self):
        return f"Param({self.label!r}, {self.kind})"


class Choice(Expr):
    """``hp.choice`` / ``hp.pchoice``: a categorical index selecting one of
    several sub-spaces."""

    __slots__ = ("label", "options", "probs")

    def __init__(self, label, options, probs=None):
        if not isinstance(label, str):
            raise TypeError(f"hyperparameter label must be a str, got {label!r}")
        options = list(options)
        if len(options) == 0:
            raise ValueError(f"hp.choice({label!r}): needs at least one option")
        if probs is not None:
            probs = [float(p) for p in probs]
            if len(probs) != len(options):
                raise ValueError(
                    f"hp.pchoice({label!r}): {len(probs)} probabilities for "
                    f"{len(options)} options")
            if any(p < 0 for p in probs):
                raise ValueError(
                    f"hp.pchoice({label!r}): negative probability")
            total = sum(probs)
            if not np.isclose(total, 1.0, atol=1e-3):
                raise ValueError(
                    f"hp.pchoice({label!r}): probabilities sum to {total}, not 1")
            probs = [p / total for p in probs]
        self.label = label
        self.options = options
        self.probs = probs

    def __repr__(self):
        return f"Choice({self.label!r}, {len(self.options)} options)"


@dataclass(frozen=True)
class ParamSpec:
    """Flat compile-time record for one scalar hyperparameter column."""

    pid: int
    label: str
    kind: str
    low: Optional[float] = None
    high: Optional[float] = None
    mu: Optional[float] = None
    sigma: Optional[float] = None
    q: Optional[float] = None
    # Categorical: prior probabilities (uniform for randint / plain choice).
    probs: Optional[tuple] = None
    n_options: int = 0
    # Conjunction of (choice pid, branch index) conditions under which this
    # parameter is live; empty = unconditional.
    conditions: tuple = ()

    @property
    def is_int(self) -> bool:
        return self.kind in _INT_KINDS

    @property
    def is_log(self) -> bool:
        return self.kind in _LOG_KINDS


def _point_value(point: dict, label: str):
    """Scalar value of ``label`` in a point dict; unwraps length-1 sequences
    (trials ``vals`` style); KeyError if absent or empty."""
    v = point[label]
    if isinstance(v, (list, tuple, np.ndarray)):
        if len(v) == 0:
            raise KeyError(label)
        v = v[0]
    return v


# Template node tags (host-side nested-structure reconstruction).
_T_LITERAL = 0
_T_PARAM = 1
_T_CHOICE = 2
_T_DICT = 3
_T_LIST = 4
_T_TUPLE = 5
_T_APPLY = 6
_T_SWITCH = 7


class CompiledSpace:
    """A search space compiled to a batched sampler + host decoder.

    * ``sample(n, generator=None, noise=None)`` -> ``(vals, active)``
    * ``decode_row(vals_row)`` -> the nested config the objective receives
    * ``eval_point(point_dict)`` -> the same, from a ``{label: value}`` dict
    * ``params`` — ordered list of :class:`ParamSpec`
    * ``device`` — where suggest algorithms run (``None``: CUDA)
    """

    def __init__(self, space):
        self._labels_seen = {}
        self._mutable_specs = []
        self.template = self._build(space, conditions=())
        self.params: list[ParamSpec] = self._mutable_specs
        del self._mutable_specs
        self.n_params = len(self.params)
        self.by_label = {p.label: p for p in self.params}
        self.device = None
        self._build_groups()

    # -- compile-time walk --------------------------------------------------

    def _add_param(self, node: Param, conditions) -> int:
        if node.label in self._labels_seen:
            raise DuplicateLabel(
                f"label {node.label!r} used more than once in the search space")
        pid = len(self._mutable_specs)
        self._labels_seen[node.label] = pid
        kw = dict(pid=pid, label=node.label, kind=node.kind,
                  conditions=tuple(conditions))
        if node.kind == CATEGORICAL:
            probs = node.probs
            kw.update(probs=tuple(float(p) for p in probs),
                      n_options=len(probs))
        elif node.kind == RANDINT:
            low = int(node.low)
            high = int(node.high)
            n = high - low
            if n <= 0:
                raise ValueError(
                    f"hp.randint({node.label!r}): empty range [{low}, {high})")
            if n > _MAX_RANDINT_RANGE or (
                    max(abs(low), abs(high)) > _MAX_RANDINT_RANGE):
                # Values live in an f32 matrix: integers above 2**24 would
                # silently lose precision.
                raise ValueError(
                    f"hp.randint({node.label!r}): range [{low}, {high}) "
                    f"needs integers beyond {_MAX_RANDINT_RANGE} (f32-exact "
                    f"integer limit); shrink/rescale the range (e.g. search "
                    f"an offset or exponent instead)")
            probs = tuple([1.0 / n] * n) if n <= _DENSE_CAT_MAX else None
            kw.update(low=float(low), high=float(high), probs=probs,
                      n_options=n)
        else:
            if node.kind in _UNIFORM_FAMILY:
                low, high = float(node.low), float(node.high)
                if not low < high:
                    raise ValueError(
                        f"hp.{node.kind}({node.label!r}): low {low} >= high {high}")
                # Log kinds keep their bounds in log space.
                kw.update(low=low, high=high)
            else:
                kw.update(mu=float(node.mu), sigma=float(node.sigma))
            if node.kind in _Q_KINDS or node.kind == UNIFORMINT:
                q = 1.0 if node.kind == UNIFORMINT else float(node.q)
                if q <= 0:
                    raise ValueError(f"hp.{node.kind}({node.label!r}): q must be > 0")
                kw.update(q=q)
                self._check_exact_lattice(node, kw, q)
        self._mutable_specs.append(ParamSpec(**kw))
        return pid

    @staticmethod
    def _check_exact_lattice(node: Param, kw: dict, q: float) -> None:
        """Reject quantized ranges whose lattice points ``k*q`` would collide
        in f32 (``|k| > 2**24``).  Bounded kinds are checked on their bounds,
        the normal family on its 2-sigma core; normal-family tails beyond
        the edge saturate there when sampled."""
        limit = float(_MAX_RANDINT_RANGE)
        if node.kind in (QUNIFORM, UNIFORMINT):
            bad = max(abs(kw["low"]), abs(kw["high"])) / q > limit
            reach = "the bound furthest from zero"
        elif node.kind == QNORMAL:
            bad = (abs(kw["mu"]) + 2.0 * kw["sigma"]) / q > limit
            reach = "|mu| + 2*sigma"
        elif node.kind == QLOGUNIFORM:
            bad = kw["high"] > math.log(limit) + math.log(q)
            reach = "exp(high)"
        elif node.kind == QLOGNORMAL:
            bad = kw["mu"] + 2.0 * kw["sigma"] > math.log(limit) + math.log(q)
            reach = "exp(mu + 2*sigma)"
        else:
            return
        if bad:
            raise ValueError(
                f"hp.{node.kind}({node.label!r}): lattice indices up to "
                f"{reach} / q exceed {_MAX_RANDINT_RANGE}, the f32-exact "
                f"integer limit of the values matrix; values this "
                f"far from zero would silently collide on the q={q} lattice. "
                f"Shrink the range, increase q, or rescale the parameter "
                f"(e.g. search an exponent instead)")

    def _build(self, node, conditions):
        """Walk the nested structure, returning a template tree."""
        if isinstance(node, Choice):
            probs = node.probs or [1.0 / len(node.options)] * len(node.options)
            idx_param = Param(node.label, CATEGORICAL, probs=probs)
            pid = self._add_param(idx_param, conditions)
            branches = []
            for b, opt in enumerate(node.options):
                branches.append(
                    self._build(opt, conditions + ((pid, b),)))
            return (_T_CHOICE, pid, tuple(branches))
        if isinstance(node, Apply):
            if node.op == "switch":
                return self._build_switch(node, conditions)
            return (_T_APPLY, node.op,
                    tuple(self._build(a, conditions) for a in node.args))
        if isinstance(node, Param):
            pid = self._add_param(node, conditions)
            return (_T_PARAM, pid)
        if isinstance(node, dict):
            items = tuple(
                (k, self._build(v, conditions)) for k, v in node.items())
            return (_T_DICT, items)
        if isinstance(node, list):
            return (_T_LIST, tuple(self._build(v, conditions) for v in node))
        if isinstance(node, tuple):
            return (_T_TUPLE, tuple(self._build(v, conditions) for v in node))
        if isinstance(node, Expr):
            raise InvalidAnnotatedParameter(f"unknown expression node {node!r}")
        return (_T_LITERAL, node)

    def _build_switch(self, node: Apply, conditions):
        """``scope.switch(idx, *options)``.  A bare 0-based integer-family
        index compiles like ``hp.choice``; a general index expression leaves
        the branches unconditioned and selects at decode time."""
        if len(node.args) < 2:
            raise InvalidAnnotatedParameter(
                "scope.switch needs an index and at least one option")
        idx, *options = node.args
        if isinstance(idx, Param) and (
                idx.kind == CATEGORICAL
                or (idx.kind in (RANDINT, UNIFORMINT) and int(idx.low) == 0)):
            pid = self._add_param(idx, conditions)
            n_opt = self._mutable_specs[pid].n_options or (
                int(idx.high) + (1 if idx.kind == UNIFORMINT else 0))
            if n_opt != len(options):
                raise InvalidAnnotatedParameter(
                    f"scope.switch({idx.label!r}): index has {n_opt} values "
                    f"but {len(options)} options were given")
            branches = tuple(
                self._build(opt, conditions + ((pid, b),))
                for b, opt in enumerate(options))
            return (_T_CHOICE, pid, branches)
        idx_t = self._build(idx, conditions)
        branches = tuple(self._build(opt, conditions) for opt in options)
        return (_T_SWITCH, idx_t, branches)

    # -- sampler ------------------------------------------------------------

    def _build_groups(self):
        """Partition params into batched sampling groups; precompute constants
        (numpy, moved to each sampling device once by :meth:`_consts`)."""
        uf, nf, cat, wide = [], [], [], []
        for p in self.params:
            if p.kind == CATEGORICAL or (p.kind == RANDINT and
                                         p.probs is not None):
                cat.append(p)
            elif p.kind == RANDINT:
                wide.append(p)
            elif p.kind in _UNIFORM_FAMILY:
                uf.append(p)
            else:
                nf.append(p)
        self._uf, self._nf, self._cat, self._wide = uf, nf, cat, wide

        def f32(xs):
            return np.asarray(xs, dtype=np.float32)

        # Uniform family: x = a + (b-a)u in fit space (log space for log
        # kinds), then exp / round / clip.  uniformint draws quniform(q=1)
        # over [low-0.5, high+0.5], then clips.
        self._uf_a = f32([p.low if p.kind != UNIFORMINT else p.low - 0.5
                          for p in uf])
        self._uf_b = f32([p.high if p.kind != UNIFORMINT else p.high + 0.5
                          for p in uf])
        self._uf_log = np.asarray([p.is_log for p in uf], dtype=bool)
        self._uf_q = f32([p.q if p.q else 0.0 for p in uf])
        self._uf_clip_lo = f32([p.low if p.kind == UNIFORMINT else -np.inf
                                for p in uf])
        self._uf_clip_hi = f32([p.high if p.kind == UNIFORMINT else np.inf
                                for p in uf])

        self._nf_mu = f32([p.mu for p in nf])
        self._nf_sigma = f32([p.sigma for p in nf])
        self._nf_log = np.asarray([p.is_log for p in nf], dtype=bool)
        self._nf_q = f32([p.q if p.q else 0.0 for p in nf])
        # Quantized normal tails saturate at the last f32-exact lattice
        # point (+/-2**24*q).
        self._nf_clip = f32([_MAX_RANDINT_RANGE * p.q if p.q else np.inf
                             for p in nf])

        kmax = max([p.n_options for p in cat], default=1)
        self.cat_kmax = kmax
        probs = np.zeros((len(cat), kmax), dtype=np.float32)
        for i, p in enumerate(cat):
            probs[i, : p.n_options] = p.probs
        self._cat_cdf = np.cumsum(probs, axis=1, dtype=np.float32)
        self._cat_last = np.asarray([p.n_options - 1 for p in cat],
                                    dtype=np.int64)
        self._cat_offset = f32([p.low if p.kind == RANDINT else 0.0 for p in cat])

        self._wide_low = f32([int(p.low) for p in wide])
        self._wide_high = f32([int(p.high) for p in wide])

        # Column permutation: concat(uf, nf, cat, wide) order -> pid order.
        order = ([p.pid for p in uf] + [p.pid for p in nf]
                 + [p.pid for p in cat] + [p.pid for p in wide])
        self._inv_perm = np.argsort(np.asarray(order, dtype=np.int64)) \
            if order else np.zeros(0, dtype=np.int64)

        self._cond_by_pid = [p.conditions for p in self.params]

    _CONSTS = ("uf_a", "uf_b", "uf_log", "uf_q", "uf_clip_lo", "uf_clip_hi",
               "nf_mu", "nf_sigma", "nf_log", "nf_q", "nf_clip", "cat_cdf",
               "cat_last", "cat_offset", "wide_low", "wide_high", "inv_perm")

    def _consts(self, dev) -> SimpleNamespace:
        """The sampler's constants as tensors on ``dev``, uploaded once per
        device: a call of :meth:`sample` copies nothing from the host."""
        cache = self.__dict__.setdefault("_dev_consts", {})
        key = str(dev)
        if key not in cache:
            cache[key] = SimpleNamespace(**{
                k: torch.as_tensor(getattr(self, "_" + k), device=dev)
                for k in self._CONSTS})
        return cache[key]

    def noise_shapes(self, n: int) -> dict:
        """Shapes of the uniforms :meth:`sample` consumes for ``n`` rows."""
        return {"uf": (n, len(self._uf)), "nf": (n, len(self._nf)),
                "cat": (n, len(self._cat)), "wide": (n, len(self._wide))}

    def draw_uniforms(self, n: int, generator=None, device=None) -> dict:
        """The uniforms :meth:`sample` draws from ``generator`` for ``n``
        rows, in its order: ``{family: f32[n, k]}`` for each family the
        space has (:meth:`noise_shapes`)."""
        dev = resolve_device(device if device is not None else self.device)
        return {name: torch.rand(shape, generator=generator, device=dev,
                                 dtype=torch.float32)
                for name, shape in self.noise_shapes(int(n)).items()
                if shape[1]}

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               noise: Optional[dict] = None, device=None):
        """Draw ``n`` configurations: ``(vals f32[n, P], active bool[n, P])``.

        The randomness is one uniform per (row, column), keyed by family as
        in :meth:`noise_shapes`; ``noise`` supplies them (tensors or arrays
        in [0, 1)), else they are drawn from ``generator``
        (:meth:`draw_uniforms`).  Runs on ``device`` (default: the space's
        device)."""
        n = int(n)
        dev = resolve_device(device if device is not None else self.device)
        if noise is None:
            noise = self.draw_uniforms(n, generator, dev)

        def draw(name):
            shape = self.noise_shapes(n)[name]
            u = torch.as_tensor(noise[name], dtype=torch.float32, device=dev)
            if tuple(u.shape) != shape:
                raise ValueError(f"noise[{name!r}] must have shape "
                                 f"{shape}, got {tuple(u.shape)}")
            return u

        t = self._consts(dev)
        cols = []
        if self._uf:
            u = draw("uf")
            a, b = t.uf_a, t.uf_b
            x = a + (b - a) * u
            x = torch.where(t.uf_log, torch.exp(x), x)
            q = t.uf_q
            x = torch.where(q > 0, torch.round(x / torch.where(q > 0, q, 1.0))
                            * q, x)
            cols.append(torch.minimum(torch.maximum(x, t.uf_clip_lo),
                                      t.uf_clip_hi))
        if self._nf:
            u = draw("nf").clamp(_U_TINY, _U_MAX)
            x = t.nf_mu + t.nf_sigma * torch.special.ndtri(u)
            x = torch.where(t.nf_log, torch.exp(x), x)
            q = t.nf_q
            x = torch.where(q > 0, torch.round(x / torch.where(q > 0, q, 1.0))
                            * q, x)
            clip = t.nf_clip
            cols.append(torch.minimum(torch.maximum(x, -clip), clip))
        if self._cat:
            u = draw("cat").T.contiguous()                   # [D, n]
            idx = icdf_pick(u, t.cat_cdf, t.cat_last[:, None])
            cols.append(t.cat_offset + idx.T.to(torch.float32))
        if self._wide:
            u = draw("wide")
            low, high = t.wide_low, t.wide_high
            w = torch.floor(low + (high - low) * u)
            cols.append(torch.minimum(w, high - 1))
        if cols:
            vals = torch.cat(cols, dim=1)[:, t.inv_perm]
        else:
            vals = torch.zeros((n, 0), dtype=torch.float32, device=dev)
        return vals, self.active_mask(vals)

    def active_mask(self, vals):
        """bool[n, P] liveness mask from the categorical columns of ``vals``."""
        n = vals.shape[0]
        out = torch.ones((n, self.n_params), dtype=torch.bool,
                         device=vals.device)
        for pid, conds in enumerate(self._cond_by_pid):
            for cpid, branch in conds:
                out[:, pid] &= vals[:, cpid] == branch
        return out

    def active_mask_host(self, vals: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`active_mask`: a suggest step fetches only the
        values row and rebuilds the mask here."""
        vals = np.asarray(vals)
        n = vals.shape[0]
        out = np.ones((n, self.n_params), dtype=bool)
        for pid, conds in enumerate(self._cond_by_pid):
            for cpid, branch in conds:
                out[:, pid] &= vals[:, cpid] == branch
        return out

    def __getstate__(self):
        # The TPE kernel caches (tpe.get_kernel; dispatch.get_kernel's
        # sharded kernels, which also hold a mesh and its process groups),
        # the other heads' program caches (anneal, GP, ES), the sampler's
        # constants and device mode's captured runs hold device tensors;
        # they are rebuilt on demand on the device the loading process
        # resolves, and not pickled.
        state = self.__dict__.copy()
        for k in ("_tpe_kernels", "_dispatch_kernels", "_anneal_kernels",
                  "_gp_kernels", "_es_kernels", "_dev_consts",
                  "_device_runs"):
            state.pop(k, None)
        return state

    # -- host-side decoding -------------------------------------------------

    def _param_value(self, spec: ParamSpec, raw) -> Any:
        if spec.kind in (CATEGORICAL, RANDINT, UNIFORMINT):
            return int(raw)
        if spec.q:
            # Re-snap to the q-lattice in f64: the stored value is the f32
            # rounding of a lattice point, which for large non-power-of-two
            # lattices decodes off-lattice.  round(raw/q) recovers the exact
            # k, and k*q in f64 is exact.
            return float(np.round(float(raw) / spec.q) * spec.q)
        return float(raw)

    def _walk(self, getter):
        """Reconstruct the nested user config; ``getter(pid)`` supplies the
        raw value of each parameter reached along the active path."""

        def rec(t):
            tag = t[0]
            if tag == _T_LITERAL:
                return t[1]
            if tag == _T_PARAM:
                spec = self.params[t[1]]
                return self._param_value(spec, getter(t[1]))
            if tag == _T_CHOICE:
                idx = int(getter(t[1]))
                return rec(t[2][idx])
            if tag == _T_DICT:
                return {k: rec(v) for k, v in t[1]}
            if tag == _T_LIST:
                return [rec(v) for v in t[1]]
            if tag == _T_TUPLE:
                return tuple(rec(v) for v in t[1])
            if tag == _T_APPLY:
                return _SCOPE_IMPLS[t[1]](*(rec(a) for a in t[2]))
            if tag == _T_SWITCH:
                idx = int(rec(t[1]))
                if not 0 <= idx < len(t[2]):
                    raise IndexError(
                        f"scope.switch index {idx} out of range for "
                        f"{len(t[2])} options")
                return rec(t[2][idx])
            raise AssertionError(tag)

        return rec(self.template)

    def decode_row(self, vals_row, active_row=None):
        """Reconstruct the nested user config from one sample row."""
        vals_row = np.asarray(vals_row)
        return self._walk(lambda pid: vals_row[pid])

    def eval_point(self, point: dict):
        """``space_eval``: substitute a ``{label: value}`` assignment.
        Values may be scalars or length-1 sequences (trials ``vals`` style);
        only parameters on the active path are needed."""
        return self._walk(lambda pid: _point_value(point,
                                                   self.params[pid].label))

    def __repr__(self):
        return (f"CompiledSpace(P={self.n_params}, "
                f"uf={len(self._uf)}, nf={len(self._nf)}, cat={len(self._cat)})")


class _Uncacheable(Exception):
    """Space contains a literal the structural cache cannot key safely."""


_VALUE_TYPES = (str, int, float, bool, bytes, type(None), np.generic)


def _freeze(obj):
    """Hashable structural fingerprint of a space (for the compile cache);
    raises :class:`_Uncacheable` on literals outside the value types."""
    if isinstance(obj, Choice):
        return ("C", obj.label,
                None if obj.probs is None else tuple(obj.probs),
                tuple(_freeze(o) for o in obj.options))
    if isinstance(obj, Param):
        return ("P", obj.label, obj.kind, obj.low, obj.high, obj.mu,
                obj.sigma, obj.q,
                None if obj.probs is None else tuple(obj.probs))
    if isinstance(obj, Apply):
        return ("A", obj.op, tuple(_freeze(a) for a in obj.args))
    if isinstance(obj, dict):
        # Insertion order determines pid order; keys are typed so that
        # True / 1 / 1.0 do not share a compilation.
        return ("D", tuple(((type(k).__name__, k), _freeze(v))
                           for k, v in obj.items()))
    if isinstance(obj, list):
        return ("L", tuple(_freeze(v) for v in obj))
    if isinstance(obj, tuple):
        return ("T", tuple(_freeze(v) for v in obj))
    if isinstance(obj, _VALUE_TYPES):
        return ("V", type(obj).__name__, obj)
    raise _Uncacheable(type(obj).__name__)


_compile_cache: "OrderedDict[tuple, CompiledSpace]" = OrderedDict()
_COMPILE_CACHE_MAX = 64


def compile_space(space) -> CompiledSpace:
    """Compile a nested ``hp.*`` structure into a :class:`CompiledSpace`.

    Memoized on the space's structural fingerprint, so repeated ``fmin``
    calls over an equal space share one ``CompiledSpace`` and its TPE
    kernel cache."""
    if isinstance(space, CompiledSpace):
        return space
    try:
        key = _freeze(space)
    except (_Uncacheable, TypeError):
        return CompiledSpace(space)
    cs = _compile_cache.get(key)
    if cs is None:
        cs = CompiledSpace(space)
        _compile_cache[key] = cs
        if len(_compile_cache) > _COMPILE_CACHE_MAX:
            _compile_cache.popitem(last=False)
    else:
        _compile_cache.move_to_end(key)
    return cs
