"""LK — lock discipline across the threaded layers.

Scoped to the port's modules that import ``threading`` (pipeline,
service, obs, fleet, parallel, plus ``tpe._prewarm_async``).  Three rules:

LK001  Lock-order cycle: the ``with lock:`` nesting graph (lexical
       nesting plus same-module/ same-class transitive acquires through
       calls) contains a cycle — two threads taking the locks in
       opposite orders can deadlock.
LK002  Unlocked write to module-level shared mutable state (dicts /
       lists / sets / WeakKeyDictionary assigned at module scope) from
       a function that holds no lock at the write site (an unlocked
       defaultdict written from two threads).
LK003  Check-then-act race: a container is membership-tested /
       ``.get()``-probed and then subscript-written in the same
       function with neither site under a lock, or a function composes
       two same-class methods that each take the same lock (sharing an
       argument, the first result feeding a branch) without holding
       that lock across the pair — the lost-update class, the netstore
       reply-cache / kernel-cache shape.

Convention honored: a function whose docstring contains "caller holds"
is exempt from LK002/LK003 — the lock obligation is documented at the
call sites, which the checker covers when analyzing them.
"""

from __future__ import annotations

import ast

from .core import Finding, dotted_name, qualified_functions

RULES = ("LK001", "LK002", "LK003")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_CONTAINER_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                    "WeakKeyDictionary", "WeakValueDictionary", "deque",
                    "Counter"}
_MUTATORS = {"append", "update", "setdefault", "pop", "popitem", "clear",
             "add", "extend", "insert", "remove", "discard", "appendleft"}


def _imports_threading(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "threading" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "threading":
                return True
    return False


def _is_lock_ctor(call) -> bool:
    if not isinstance(call, ast.Call):
        return False
    name = dotted_name(call.func)
    return bool(name) and name.split(".")[-1] in _LOCK_CTORS


def _is_container_ctor(node) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        return bool(name) and name.split(".")[-1] in _CONTAINER_CTORS
    return False


class _ModuleLocks:
    """Lock and shared-container tables for one module."""

    def __init__(self, module):
        self.module = module
        self.module_locks: set = set()          # bare names
        self.instance_locks: dict = {}          # class -> {attr}
        self.shared: set = set()                # module-level container names
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if _is_lock_ctor(node.value):
                    self.module_locks.add(name)
                elif _is_container_ctor(node.value):
                    self.shared.add(name)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and node.value is not None:
                if _is_lock_ctor(node.value):
                    self.module_locks.add(node.target.id)
                elif _is_container_ctor(node.value):
                    self.shared.add(node.target.id)
        for cls in module.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs = set()
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            attrs.add(tgt.attr)
            if attrs:
                self.instance_locks[cls.name] = attrs

    def lock_id(self, expr, cls):
        """Canonical lock node id for a with-item expr, else None."""
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return expr.id
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if base == "self" and cls and \
                    attr in self.instance_locks.get(cls, ()):
                return f"{cls}.{attr}"
            # obj._lock on a known lock-bearing class attr: match by attr
            for cname, attrs in self.instance_locks.items():
                if attr in attrs:
                    return f"{cname}.{attr}"
        return None


def _caller_holds(fn) -> bool:
    doc = ast.get_docstring(fn) or ""
    return "caller holds" in doc.lower()


def _direct_acquires(fn, locks: _ModuleLocks, cls):
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                lid = locks.lock_id(item.context_expr, cls)
                if lid:
                    out.add(lid)
    return out


def _transitive_acquires(locks: _ModuleLocks):
    """Fixpoint of acquire sets through same-module / same-class calls."""
    funcs = {}
    for qual, node, cls in qualified_functions(locks.module.tree):
        funcs[qual] = (node, cls)
    acq = {q: _direct_acquires(n, locks, c) for q, (n, c) in funcs.items()}
    callees = {}
    for qual, (node, cls) in funcs.items():
        outs = set()
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Name) and sub.func.id in funcs:
                outs.add(sub.func.id)
            elif isinstance(sub.func, ast.Attribute) and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == "self" and cls and \
                    f"{cls}.{sub.func.attr}" in funcs:
                outs.add(f"{cls}.{sub.func.attr}")
        callees[qual] = outs
    changed = True
    while changed:
        changed = False
        for qual, outs in callees.items():
            merged = set(acq[qual])
            for o in outs:
                merged |= acq[o]
            if merged != acq[qual]:
                acq[qual] = merged
                changed = True
    return funcs, acq, callees


def _order_edges(locks: _ModuleLocks, funcs, acq):
    """(held, acquired, line) edges from nesting + calls under a lock."""
    edges = []

    def scan(body, held, cls, qual):
        for node in body:
            if isinstance(node, ast.With):
                ids = [locks.lock_id(i.context_expr, cls)
                       for i in node.items]
                ids = [i for i in ids if i]
                for h in held:
                    for lid in ids:
                        if h != lid:
                            edges.append((h, lid, node.lineno))
                scan(node.body, held + ids, cls, qual)
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and held:
                    callee = None
                    if isinstance(sub.func, ast.Name) and \
                            sub.func.id in funcs:
                        callee = sub.func.id
                    elif isinstance(sub.func, ast.Attribute) and \
                            isinstance(sub.func.value, ast.Name) and \
                            sub.func.value.id == "self" and cls and \
                            f"{cls}.{sub.func.attr}" in funcs:
                        callee = f"{cls}.{sub.func.attr}"
                    if callee:
                        for lid in acq.get(callee, ()):
                            for h in held:
                                if h != lid:
                                    edges.append((h, lid, sub.lineno))
            for attr in ("body", "orelse", "finalbody"):
                inner = getattr(node, attr, None)
                if inner:
                    scan(inner, held, cls, qual)
            for handler in getattr(node, "handlers", []):
                scan(handler.body, held, cls, qual)

    for qual, (node, cls) in funcs.items():
        scan(node.body, [], cls, qual)
    return edges


def _find_cycles(edges):
    graph: dict = {}
    for a, b, _line in edges:
        graph.setdefault(a, set()).add(b)
    cycles, seen = [], set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for nxt in sorted(graph.get(cur, ())):
                if nxt == start and len(path) > 1:
                    key = frozenset(path)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(path + [start])
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return cycles


class _BodyScan:
    """Lexical scan of one function: lock-held state per site."""

    def __init__(self, locks, cls):
        self.locks = locks
        self.cls = cls
        self.shared_writes = []     # (name, line, held?)
        self.tests = {}             # container expr -> held?
        self.stores = {}            # container expr -> (line, held?)
        self.locked_method_calls = []   # (method, lockid, args, test?, line)

    def scan(self, body, held, under_test=False):
        for node in body:
            if isinstance(node, ast.With):
                ids = [self.locks.lock_id(i.context_expr, self.cls)
                       for i in node.items]
                self.scan(node.body, held + [i for i in ids if i])
                self._expr_walk(node, held, skip_body=True)
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue    # nested def: own thread-entry analysis
            self._expr_walk(node, held)
            if isinstance(node, (ast.If, ast.While)):
                self._record_tests(node.test, held)
            for attr in ("body", "orelse", "finalbody"):
                inner = getattr(node, attr, None)
                if inner:
                    self.scan(inner, held)
            for handler in getattr(node, "handlers", []):
                self.scan(handler.body, held)

    def _record_tests(self, test, held):
        for node in ast.walk(test):
            expr = None
            if isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                expr = dotted_name(node.comparators[0])
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get":
                expr = dotted_name(node.func.value)
            if expr:
                self.tests[expr] = self.tests.get(expr, False) or bool(held)

    def _expr_walk(self, stmt, held, skip_body=False):
        nodes = []
        if skip_body:
            for item in getattr(stmt, "items", []):
                nodes.extend(ast.walk(item))
        else:
            if isinstance(stmt, (ast.If, ast.While)):
                nodes = list(ast.walk(stmt.test))
            elif isinstance(stmt, ast.Assign):
                nodes = list(ast.walk(stmt))
            elif isinstance(stmt, (ast.Expr, ast.Return, ast.AugAssign,
                                   ast.AnnAssign, ast.Delete, ast.Raise,
                                   ast.Assert)):
                nodes = list(ast.walk(stmt))
            else:
                return
        for node in nodes:
            # stores: D[k] = v / del D[k]
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                expr = dotted_name(node.value)
                if expr:
                    base = expr.split(".")[0]
                    if expr in self.locks.shared or \
                            base in self.locks.shared:
                        self.shared_writes.append(
                            (expr, node.lineno, bool(held)))
                    prev = self.stores.get(expr)
                    if prev is None or (prev[1] and not held):
                        self.stores[expr] = (node.lineno, bool(held))
            # mutator calls on shared module containers: D.append(...)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                expr = dotted_name(node.func.value)
                if expr and expr in self.locks.shared:
                    self.shared_writes.append((expr, node.lineno, bool(held)))
            # `x = D.get(k)` probes outside an If test
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get":
                expr = dotted_name(node.func.value)
                if expr:
                    self.tests[expr] = \
                        self.tests.get(expr, False) or bool(held)
            # same-class locked-method calls (for the compose rule)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self" and not held:
                self.locked_method_calls.append(
                    (node.func.attr,
                     tuple(ast.dump(a) for a in node.args), node.lineno))


def _check_module(findings, locks: _ModuleLocks):
    rel = locks.module.rel
    funcs, acq, _callees = _transitive_acquires(locks)

    # LK001 — cycles
    edges = _order_edges(locks, funcs, acq)
    for cycle in _find_cycles(edges):
        findings.append(Finding(
            "LK001", rel, min(l for a, b, l in edges
                              if a in cycle and b in cycle),
            "<module>",
            "lock-order cycle: " + " -> ".join(cycle)))

    for qual, (fn, cls) in funcs.items():
        if _caller_holds(fn):
            continue
        scan = _BodyScan(locks, cls)
        scan.scan(fn.body, [])

        # LK002 — unlocked writes to module-level shared containers
        reported = set()
        for name, line, held in scan.shared_writes:
            if not held and name not in reported:
                reported.add(name)
                findings.append(Finding(
                    "LK002", rel, line, qual,
                    f"write to module-level shared container '{name}' "
                    "without holding a lock"))

        # LK003a — lexical check-then-act on one container.  Bare local
        # names are function-private (no race); only module-level shared
        # containers and dotted state (self.X / obj.X) qualify.
        for expr, tested_held in scan.tests.items():
            stored = scan.stores.get(expr)
            if stored and not tested_held and not stored[1]:
                base = expr.split(".")[0]
                if "." not in expr and expr not in locks.shared:
                    continue
                if base == "self" and cls and \
                        not locks.instance_locks.get(cls):
                    continue    # class has no lock: single-threaded by design
                findings.append(Finding(
                    "LK003", rel, stored[0], qual,
                    f"check-then-act on '{expr}': membership/get probe and "
                    "subscript write with no lock held across the pair"))

        # LK003b — non-atomic compose of two locked same-class methods
        if cls and locks.instance_locks.get(cls):
            calls = [(m, args, line) for m, args, line
                     in scan.locked_method_calls
                     if f"{cls}.{m}" in acq and acq[f"{cls}.{m}"]]
            for i, (m1, a1, l1) in enumerate(calls):
                for m2, a2, l2 in calls[i + 1:]:
                    if m1 == m2 or not (set(a1) & set(a2)):
                        continue
                    common = acq[f"{cls}.{m1}"] & acq[f"{cls}.{m2}"]
                    if common:
                        findings.append(Finding(
                            "LK003", rel, l2, qual,
                            f"calls {m1}()/{m2}() each take "
                            f"{sorted(common)[0]} but '{qual}' composes "
                            "them without holding it — the pair is not "
                            "atomic"))
                        break
                else:
                    continue
                break

    return findings


def check(project) -> list:
    findings: list = []
    for module in project.package_modules():
        if not _imports_threading(module.tree):
            continue
        _check_module(findings, _ModuleLocks(module))
    return findings
