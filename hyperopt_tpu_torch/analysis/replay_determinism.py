"""RT — replay determinism: nothing reachable from WAL replay may
depend on the machine it replays on.

The byte-identity scrub of the service tier compares ``state_bytes()``
between a primary and a replica that each rebuilt their store by
re-executing WAL records.  That comparison is only meaningful if the
replay path is a pure function of the log: the one sanctioned clock is
the pinned ``now_override`` (each record replays at its logged ``t``),
and entropy, wall clocks, environment reads, or unordered-set
iteration anywhere on the path turns an honest divergence detector
into a flake.  These checkers BFS the static call graph from the
replay entry points and flag nondeterminism taint.

Entry points (structural, no imports): functions that assign
``_replaying = True`` (the recovery and wal-ship apply paths), call
``maybe_fail("wal.replay", ...)``, are named ``_apply_record``, or are
the serialization surface itself (``state_dict`` / ``state_bytes`` /
``state_payload`` — what the scrub hashes).

RT001  Wall-clock read (``time.time``, ``datetime.now``/``utcnow``,
       ``coarse_utcnow``) in a replay-reachable function.  Functions
       that reference ``now_override`` are the pinned-clock pattern
       itself and are exempt.
RT002  Entropy (``random.*``, ``os.urandom``, ``uuid.*``,
       ``secrets.*``) in a replay-reachable function — two replays of
       one log diverge by construction.
RT003  Environment read (``os.environ`` / ``os.getenv``) in a
       replay-reachable function — replay outcome depends on deploy
       env, not the log.
RT004  Iteration over a ``set`` (or ``list(set)``/``tuple(set)``) in a
       replay-reachable function without ``sorted()`` — serialized
       output inherits hash order.

Call-graph resolution (over-approximate by design): plain names
resolve same-module; ``self.M``/``super().M`` resolve to any method
named ``M`` in the same module, else in ``hyperopt_tpu_torch/service/``;
``super().M`` additionally takes candidates across the store substrate
(``hyperopt_tpu_torch/parallel/``) because that is the one edge where
the override chain crosses modules (ServiceServer extends netstore's
StoreServer — the dispatch arms replay re-executes live there);
``self.attr.M`` and store-alias (``ft``) receivers resolve by method
name within the service package only — the store replay mutates is
``service/store.MemTrials``, not the file/net client stores that happen
to share method names.  A leading ``if self._replaying ...: return``
guard marks everything below it as live-only and prunes the walk.
"""

from __future__ import annotations

import ast

from .core import Finding, call_func_name, qualified_functions, str_const

RULES = ("RT001", "RT002", "RT003", "RT004")

_SERVICE_PREFIX = "hyperopt_tpu_torch/service/"
#: Where replay-reachable methods may live: the service fleet plus the
#: store substrate it subclasses (ServiceServer extends netstore's
#: StoreServer; the dispatch arms replay re-executes are defined there).
_REPLAY_PREFIXES = ("hyperopt_tpu_torch/service/",
                     "hyperopt_tpu_torch/parallel/")

_WALL_CLOCKS = frozenset({"time.time", "datetime.now", "datetime.utcnow",
                          "coarse_utcnow"})
_ENTROPY_ROOTS = frozenset({"random", "uuid", "secrets"})
_ROOT_NAMES = frozenset({"state_dict", "state_bytes", "state_payload",
                         "_apply_record"})


def _replay_stmts(body):
    """Statements of a body that are on the replay path: a leading
    ``if self._replaying or ...: return`` guard routes replay into its
    own branch, so everything after it is live-only."""
    out = []
    for stmt in body:
        if isinstance(stmt, ast.If) and _positive_replaying(stmt.test) \
                and stmt.body and isinstance(stmt.body[-1], ast.Return):
            out.extend(stmt.body)
            break
        out.append(stmt)
    return out


def _positive_replaying(test) -> bool:
    """Does the test read ``_replaying`` outside a ``not``?"""
    negated = set()
    for node in ast.walk(test):
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            for sub in ast.walk(node.operand):
                negated.add(id(sub))
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr == "_replaying" \
                and id(node) not in negated:
            return True
    return False


class _Graph:
    def __init__(self, project):
        self.project = project
        self.funcs: dict[tuple, ast.AST] = {}        # (rel, qual) -> node
        self.by_module: dict[str, dict] = {}          # rel -> {name: qual}
        self.service_methods: dict[str, list] = {}    # name -> [(rel, qual)]
        self.substrate_methods: dict[str, list] = {}  # super() chain only
        self.roots: set[tuple] = set()
        # Classes the service package names as bases: the only classes
        # whose methods a service-side ``super().M`` can land on.
        base_names: set = set()
        for module in project.package_modules():
            if not module.rel.startswith(_SERVICE_PREFIX):
                continue
            for node in ast.walk(module.tree):
                if isinstance(node, ast.ClassDef):
                    for b in node.bases:
                        bn = b.id if isinstance(b, ast.Name) else (
                            b.attr if isinstance(b, ast.Attribute)
                            else None)
                        if bn:
                            base_names.add(bn)
        for module in project.package_modules():
            rel = module.rel
            names = {}
            for qual, func, cls in qualified_functions(module.tree):
                key = (rel, qual)
                self.funcs[key] = func
                name = qual.rsplit(".", 1)[-1]
                names.setdefault(name, []).append(qual)
                if rel.startswith(_REPLAY_PREFIXES) and cls in base_names:
                    self.substrate_methods.setdefault(name, []) \
                        .append(key)
                if rel.startswith(_SERVICE_PREFIX):
                    self.service_methods.setdefault(name, []).append(key)
                if self._is_root(rel, name, func):
                    self.roots.add(key)
            self.by_module[rel] = names

    @staticmethod
    def _is_root(rel, name, func) -> bool:
        # Serialization-surface roots only anchor in the service package
        # (other subsystems reuse these method names); the structural
        # markers (_replaying, wal.replay hooks) anchor anywhere.
        if name in _ROOT_NAMES and rel.startswith(_SERVICE_PREFIX):
            return True
        for node in ast.walk(func):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                # Only *entering* replay marks a root: ``__init__``'s
                # ``self._replaying = False`` initializer and the
                # ``finally`` reset are live-side bookkeeping.
                value = node.value if isinstance(node, ast.Assign) else None
                if not (isinstance(value, ast.Constant)
                        and value.value is True):
                    continue
                for t in targets:
                    tn = t.attr if isinstance(t, ast.Attribute) else (
                        t.id if isinstance(t, ast.Name) else None)
                    if tn == "_replaying":
                        return True
            elif isinstance(node, ast.Call):
                name_ = call_func_name(node) or ""
                if name_.rsplit(".", 1)[-1] == "maybe_fail" and node.args:
                    point = str_const(node.args[0]) or ""
                    if point.startswith("wal.replay"):
                        return True
        return False

    def edges(self, key) -> set:
        rel, _qual = key
        func = self.funcs[key]
        out: set[tuple] = set()
        store_aliases = {"ft"}
        for node in self._replay_walk(func):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                tail = (call_func_name(node.value) or "").rsplit(".", 1)[-1]
                if tail.endswith("_store"):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            store_aliases.add(t.id)
        for node in self._replay_walk(func):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                for qual in self.by_module[rel].get(f.id, ()):
                    out.add((rel, qual))
            elif isinstance(f, ast.Attribute):
                m = f.attr
                recv = f.value
                is_selfish = (
                    (isinstance(recv, ast.Name)
                     and (recv.id in ("self", "cls")
                          or recv.id in store_aliases))
                    or (isinstance(recv, ast.Call)
                        and (call_func_name(recv) or "") == "super")
                    or (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"))
                if not is_selfish:
                    continue
                local = [(rel, q) for q in self.by_module[rel].get(m, ())]
                direct_self = isinstance(recv, ast.Name) \
                    and recv.id in ("self", "cls")
                if isinstance(recv, ast.Call):
                    # super().M: the override chain crosses modules
                    # (ServiceServer -> StoreServer), so take both the
                    # same-module and the substrate-wide candidates.
                    out.update(local)
                    out.update(self.service_methods.get(m, []))
                    out.update(self.substrate_methods.get(m, []))
                elif local and direct_self:
                    out.update(local)
                else:
                    cross = self.service_methods.get(m, [])
                    out.update(cross if cross else local)
        return out

    def _replay_walk(self, func):
        for stmt in _replay_stmts(func.body):
            yield from ast.walk(stmt)

    def reachable(self) -> set:
        seen = set(self.roots)
        frontier = list(self.roots)
        while frontier:
            key = frontier.pop()
            for nxt in self.edges(key):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen


def _references_now_override(func) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Attribute) and node.attr == "now_override":
            return True
        if isinstance(node, ast.Name) and node.id == "now_override":
            return True
    return False


def _set_names(func, cls_sets) -> set:
    """Local names bound to set values, plus class-level set attrs."""
    names = set(cls_sets)
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            v = node.value
            is_set = isinstance(v, ast.Set) or (
                isinstance(v, ast.Call)
                and (call_func_name(v) or "") in ("set", "frozenset"))
            if is_set:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _class_set_attrs(project) -> dict:
    """{rel: {class: set(attrs assigned set()/frozenset())}}"""
    out: dict = {}
    for module in project.package_modules():
        rel = module.rel
        per = {}
        for node in module.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            attrs = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) \
                        and isinstance(sub.value, ast.Call) \
                        and (call_func_name(sub.value) or "") in (
                            "set", "frozenset"):
                    for t in sub.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            attrs.add(t.attr)
            if attrs:
                per[node.name] = attrs
        if per:
            out[rel] = per
    return out


def check(project) -> list:
    graph = _Graph(project)
    if not graph.roots:
        return []
    findings: list = []
    set_attrs_by_mod = _class_set_attrs(project)
    seen_keys = set()

    for rel, qual in sorted(graph.reachable()):
        func = graph.funcs[(rel, qual)]
        pinned = _references_now_override(func)
        cls = qual.split(".")[0] if "." in qual else None
        cls_sets = set_attrs_by_mod.get(rel, {}).get(cls, set())
        local_sets = _set_names(func, set())

        for node in _replay_stmts(func.body):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    name = call_func_name(sub) or ""
                    tail = name.rsplit(".", 1)[-1]
                    dotted2 = ".".join(name.split(".")[-2:])
                    if not pinned and (dotted2 in _WALL_CLOCKS
                                       or tail == "coarse_utcnow"):
                        _emit(findings, seen_keys, "RT001", rel, sub.lineno,
                              qual, f"wall-clock read {name}() on the WAL "
                              f"replay path — replays at different times "
                              f"diverge; use the pinned now_override clock")
                    root = name.split(".")[0]
                    if root in _ENTROPY_ROOTS or dotted2 == "os.urandom":
                        _emit(findings, seen_keys, "RT002", rel, sub.lineno,
                              qual, f"entropy source {name}() on the WAL "
                              f"replay path — two replays of one log "
                              f"diverge by construction")
                    if dotted2 in ("os.getenv", "environ.get"):
                        _emit(findings, seen_keys, "RT003", rel, sub.lineno,
                              qual, f"environment read {name}() on the WAL "
                              f"replay path — replay depends on deploy "
                              f"env, not the log")
                    if tail in ("list", "tuple") and sub.args:
                        a = sub.args[0]
                        if _is_set_expr(a, local_sets, cls_sets):
                            _emit(findings, seen_keys, "RT004", rel,
                                  sub.lineno, qual,
                                  "materializing a set in hash order on "
                                  "the replay path — wrap in sorted()")
                elif isinstance(sub, ast.Subscript) \
                        and isinstance(sub.value, ast.Attribute) \
                        and isinstance(sub.value.value, ast.Name) \
                        and sub.value.value.id == "os" \
                        and sub.value.attr == "environ" \
                        and isinstance(sub.ctx, ast.Load):
                    _emit(findings, seen_keys, "RT003", rel, sub.lineno,
                          qual, "os.environ[...] read on the WAL replay "
                          "path — replay depends on deploy env, not the "
                          "log")
                elif isinstance(sub, (ast.For, ast.comprehension)):
                    it = sub.iter
                    if _is_set_expr(it, local_sets, cls_sets):
                        line = getattr(sub, "lineno", getattr(
                            it, "lineno", func.lineno))
                        _emit(findings, seen_keys, "RT004", rel, line, qual,
                              "iterating a set in hash order on the "
                              "replay path — wrap in sorted()")
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def _is_set_expr(node, local_sets, cls_sets) -> bool:
    if isinstance(node, ast.Name):
        return node.id in local_sets
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr in cls_sets
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.Call) and (call_func_name(node) or "") in (
            "set", "frozenset"):
        return True
    return False


def _emit(findings, seen, rule, rel, line, qual, msg):
    key = (rule, rel, qual, line)
    if key in seen:
        return
    seen.add(key)
    findings.append(Finding(rule, rel, line, qual, msg))
