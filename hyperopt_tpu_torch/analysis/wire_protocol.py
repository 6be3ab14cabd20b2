"""WP — wire-protocol coherence: clients, dispatchers, and the WAL agree.

The service fleet's exactly-once story rests on three
cross-process contracts no single module can see whole: every verb a
client emits has a dispatcher arm (and vice versa), every field a
dispatcher *requires* is supplied at every call site, and the verbs
that mutate durable store state are exactly the verbs that are WAL-
logged and idempotency-keyed.  These checkers reconcile all three from
source text alone.

WP001  A client RPC call site emits a verb no dispatcher arm handles —
       the request can only ever come back ``unknown verb``.
WP002  A dispatcher arm handles a verb nothing emits and no ``*_VERBS``
       catalog names — dead protocol surface (or a client was lost).
WP003  A client call site omits a field the dispatcher arm reads with
       ``req["field"]`` (a hard KeyError on the server).  Sites that
       splat ``**kw`` and the fields ``_Rpc.__call__`` injects
       (``verb``/``exp_key``/``idem``/``ctx``) are exempt.
WP004  A verb that mutates durable store state is neither in a
       ``*_MUTATING_VERBS`` catalog (the client auto-attaches an
       idempotency key — the attach itself is verified structurally)
       nor declared retry-convergent in a ``*_IDEMPOTENT_VERBS``
       catalog: a retried request can execute twice.
WP005  A ``*_WAL_VERBS`` catalog disagrees with the set of dispatcher
       arms that actually mutate durable store state — either a WAL-
       logged verb whose replay re-executes a read, or a mutation that
       survives no crash.  "Durable" is computed, not assumed: the
       attributes ``state_dict`` serializes.
WP006  Catalog hygiene: a verb in both ``*_MUTATING_VERBS`` and
       ``*_IDEMPOTENT_VERBS`` (contradiction), or declared idempotent
       without being a mutating verb at all (stale declaration).  The
       same two readings hold a ``*_CONTROL_VERBS`` catalog (ephemeral
       server directives such as ``shed`` and ``fence``, which touch no
       durable state) against the dispatcher: a control verb that is
       also in a mutating or idempotent catalog (contradiction), or
       whose dispatcher arm mutates durable store state or which has no
       arm at all (stale declaration).  A control verb gets no WP004
       exemption: if its arm mutates, WP004 fires as for any verb.
WP007  A verb declared in a ``*_READONLY_VERBS`` catalog (the server
       serves these on the lock-free read path, off the write lock and
       ahead of any fsync queue) mutates durable store state, appears
       in a mutating/WAL/idempotent catalog, or names no dispatcher
       arm at all — any of which lets a "read" race the writers the
       dispatch lock exists to serialize.
WP008  Binary-frame coverage: every verb in a ``*FRAMED_VERBS``
       catalog (its request/reply bodies ride the columnar binary
       frame) must have a dispatcher arm AND a ``CODEC_FIXTURES``
       entry carrying BOTH directions (``req`` and ``reply`` bodies —
       the shared fixtures ``test_wire.py`` round-trips through client
       encode ↔ server decode), and every fixture key must still be a
       framed verb.  Keeps the WP001–WP006 ground truth honest when a
       verb's bytes stop being JSON.

Conventions honored (all structural, none import-time): client call
sites are calls whose callee name ends in ``rpc`` (``self._rpc``,
``old_rpc``, ``self._fleet_rpc(url)(...)``) or is ``_router``, with a
string-literal verb as first argument; dispatcher arms are
``verb == "x"`` comparisons inside functions whose name contains
``dispatch`` or is ``do_POST``; the store variable in a dispatcher is
``ft`` or any name assigned from a ``*_store(...)`` call, followed
through helper calls that pass it on (bounded depth).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, call_func_name, qualified_functions, str_const

RULES = ("WP001", "WP002", "WP003", "WP004", "WP005", "WP006", "WP007",
         "WP008")

#: Fields _Rpc.__call__ injects into every request on the client side
#: (``wait_s`` rides along only on long-poll reserve, popped by the
#: dispatcher before the verb arm ever sees the request).
_IMPLICIT_FIELDS = frozenset({"verb", "exp_key", "idem", "ctx", "wait_s"})

#: Container methods that mutate their receiver in place.
_MUTATORS = frozenset({
    "append", "add", "update", "pop", "popitem", "clear", "setdefault",
    "extend", "insert", "remove", "discard", "move_to_end",
})

_FOLLOW_DEPTH = 3

#: What a verb looks like — filters URL/token literals handed to
#: ``_Rpc(...)`` constructors out of the client-site extraction.
_VERB_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _literal_strs(node):
    """String elements of a set/list/tuple literal, unwrapping a
    ``frozenset({...})`` / ``set([...])`` call."""
    if isinstance(node, ast.Call) and call_func_name(node) in (
            "frozenset", "set") and node.args:
        node = node.args[0]
    if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
        out = []
        for el in node.elts:
            s = str_const(el)
            if s is None:
                return None
            out.append(s)
        return out
    return None


def _callee_tail(call: ast.Call) -> str | None:
    """Trailing name of the callee, looking through one call layer so
    ``self._fleet_rpc(url)("promote")`` resolves to ``_fleet_rpc``."""
    func = call.func
    if isinstance(func, ast.Call):
        inner = call_func_name(func)
        return inner.rsplit(".", 1)[-1] if inner else None
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class _ClientSite:
    __slots__ = ("verb", "rel", "line", "symbol", "kwargs", "has_star")

    def __init__(self, verb, rel, line, symbol, kwargs, has_star):
        self.verb, self.rel, self.line = verb, rel, line
        self.symbol, self.kwargs, self.has_star = symbol, kwargs, has_star


class _Arm:
    __slots__ = ("verb", "rel", "line", "symbol", "body")

    def __init__(self, verb, rel, line, symbol, body):
        self.verb, self.rel, self.line = verb, rel, line
        self.symbol, self.body = symbol, body


def _arm_verbs(test) -> list:
    """Verbs of a ``verb == "x"`` (or ``verb in ("x", "y")``) test."""
    if not (isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and test.left.id == "verb"
            and len(test.ops) == 1):
        return []
    if isinstance(test.ops[0], ast.Eq):
        s = str_const(test.comparators[0])
        return [s] if s is not None else []
    return []


class _Extract:
    """One pass over the project: client sites, dispatcher arms,
    catalogs, and the idempotency-attach proof."""

    def __init__(self, project):
        self.client_sites: list[_ClientSite] = []
        self.arms: dict[str, list[_Arm]] = {}
        # catalogs: suffix-keyed {name: (rel, line, set(verbs))}
        self.mutating: dict[str, tuple] = {}
        self.idempotent: dict[str, tuple] = {}
        self.wal: dict[str, tuple] = {}
        self.readonly: dict[str, tuple] = {}
        self.control: dict[str, tuple] = {}
        self.framed: dict[str, tuple] = {}
        # CODEC_FIXTURES: verb -> (rel, line, has_req, has_reply)
        self.codec_fixtures: dict[str, tuple] = {}
        self.other_catalog_verbs: set[str] = set()
        self.idem_attach_proven = False
        self.funcs: dict[tuple, ast.AST] = {}     # (rel, name) -> node
        self.methods: dict[str, list] = {}        # name -> [(rel, node)]
        self.project = project
        for module in project.package_modules():
            rel = module.rel
            self._scan_module(rel, module.tree)

    def _scan_module(self, rel, tree):
        top = set()
        for qualname, func, _cls in qualified_functions(tree):
            name = qualname.rsplit(".", 1)[-1]
            top.add(id(func))
            self.funcs[(rel, qualname)] = func
            self.methods.setdefault(name, []).append((rel, func))
            self._scan_function(rel, qualname, func)
        # Dispatchers hidden from qualified_functions — a ``do_POST``
        # on a handler class built inside a factory method (the router)
        # still holds arms; client sites inside it were already picked
        # up by the enclosing method's walk, so extract arms only.
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(node) not in top \
                    and ("dispatch" in node.name
                         or node.name == "do_POST"):
                self._scan_arms(rel, node.name, node)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                tname = target.id if isinstance(target, ast.Name) else (
                    target.attr if isinstance(target, ast.Attribute)
                    else None)
                if not tname or not tname.endswith("_VERBS"):
                    continue
                verbs = _literal_strs(node.value)
                if verbs is None:
                    continue
                entry = (rel, node.lineno, frozenset(verbs))
                if tname.endswith("_MUTATING_VERBS"):
                    self.mutating[tname] = entry
                elif tname.endswith("_IDEMPOTENT_VERBS"):
                    self.idempotent[tname] = entry
                elif tname.endswith("_WAL_VERBS"):
                    self.wal[tname] = entry
                elif tname.endswith("_READONLY_VERBS"):
                    self.readonly[tname] = entry
                elif tname.endswith("_CONTROL_VERBS"):
                    self.control[tname] = entry
                elif tname.endswith("FRAMED_VERBS"):
                    self.framed[tname] = entry
                else:
                    self.other_catalog_verbs.update(verbs)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "CODEC_FIXTURES" \
                    and isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    verb = str_const(k)
                    if verb is None:
                        continue
                    dirs = set()
                    if isinstance(v, ast.Dict):
                        dirs = {str_const(dk) for dk in v.keys}
                    self.codec_fixtures[verb] = (
                        rel, node.lineno, "req" in dirs, "reply" in dirs)

    def _scan_arms(self, rel, qualname, func):
        for node in ast.walk(func):
            if isinstance(node, ast.If):
                for verb in _arm_verbs(node.test):
                    self.arms.setdefault(verb, []).append(_Arm(
                        verb, rel, node.lineno, qualname, node.body))

    def _scan_function(self, rel, qualname, func):
        in_dispatch = "dispatch" in func.name or func.name == "do_POST"
        tests_mutating = False
        stores_idem = False
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                tail = _callee_tail(node)
                if tail and (tail.lower().endswith("rpc")
                             or tail == "_router") and node.args:
                    verb = str_const(node.args[0])
                    if verb is not None and _VERB_RE.match(verb):
                        kwargs = {kw.arg for kw in node.keywords
                                  if kw.arg is not None}
                        star = any(kw.arg is None for kw in node.keywords)
                        self.client_sites.append(_ClientSite(
                            verb, rel, node.lineno, qualname, kwargs, star))
            elif isinstance(node, ast.If) and in_dispatch:
                for verb in _arm_verbs(node.test):
                    self.arms.setdefault(verb, []).append(_Arm(
                        verb, rel, node.lineno, qualname, node.body))
            elif isinstance(node, ast.Compare):
                for comp in node.comparators:
                    name = comp.id if isinstance(comp, ast.Name) else (
                        comp.attr if isinstance(comp, ast.Attribute)
                        else None)
                    if name and name.endswith("_MUTATING_VERBS"):
                        tests_mutating = True
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and str_const(t.slice) == "idem":
                        stores_idem = True
        if tests_mutating and stores_idem:
            self.idem_attach_proven = True

    # -- durable-state analysis ----------------------------------------------

    def durable_classes(self):
        """{(rel, class): frozenset(durable attrs)} for every class whose
        ``state_dict`` defines what durability means."""
        out = {}
        for module in self.project.package_modules():
            rel = module.rel
            for node in module.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) \
                            and sub.name == "state_dict":
                        attrs = self._self_attr_loads(sub)
                        if attrs:
                            out[(rel, node.name)] = frozenset(attrs)
        return out

    @staticmethod
    def _self_attr_loads(func):
        called, withctx = set(), set()
        for node in ast.walk(func):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                called.add(node.func.attr)
            elif isinstance(node, ast.withitem):
                for sub in ast.walk(node.context_expr):
                    if isinstance(sub, ast.Attribute) \
                            and isinstance(sub.value, ast.Name) \
                            and sub.value.id == "self":
                        withctx.add(sub.attr)
        attrs = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and node.attr not in called and node.attr not in withctx:
                attrs.add(node.attr)
        return attrs

    def mutating_methods(self, durable):
        """Names of store methods that mutate a durable attribute,
        closed over same-class method calls."""
        by_class = {}
        for module in self.project.package_modules():
            rel = module.rel
            for node in module.tree.body:
                if isinstance(node, ast.ClassDef) \
                        and (rel, node.name) in durable:
                    by_class[(rel, node.name)] = node
        mutating: set[str] = set()
        calls: dict[str, set] = {}
        for key, cls in by_class.items():
            attrs = durable[key]
            for sub in cls.body:
                if not isinstance(sub, ast.FunctionDef):
                    continue
                if _mutates_attrs(sub, attrs, receiver="self"):
                    mutating.add(sub.name)
                callees = set()
                for node in ast.walk(sub):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id == "self":
                        callees.add(node.func.attr)
                calls.setdefault(sub.name, set()).update(callees)
        changed = True
        while changed:
            changed = False
            for name, callees in calls.items():
                if name not in mutating and callees & mutating:
                    mutating.add(name)
                    changed = True
        return mutating

    # -- dispatcher arm analysis ---------------------------------------------

    def _store_aliases(self, func, extra=()):
        aliases = set(extra)
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                tail = _callee_tail(node.value)
                if tail and tail.endswith("_store"):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            aliases.add(t.id)
        aliases.add("ft")
        return aliases

    def arm_required_fields(self, arm: _Arm) -> set:
        """``req["field"]`` reads in the arm body, following helper
        calls that receive ``req`` (bounded depth)."""
        fields: set[str] = set()
        self._walk_req(arm.body, arm.rel, fields, _FOLLOW_DEPTH, set())
        return fields

    def _walk_req(self, body, rel, fields, depth, seen):
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Subscript) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "req" \
                        and isinstance(node.ctx, ast.Load):
                    s = str_const(node.slice)
                    if s is not None:
                        fields.add(s)
                elif isinstance(node, ast.Call) and depth > 0:
                    passes_req = any(
                        isinstance(a, ast.Name) and a.id == "req"
                        for a in node.args)
                    if not passes_req:
                        continue
                    tail = _callee_tail(node)
                    for trel, tfunc in self.methods.get(tail, ()):
                        key = (trel, tfunc.name)
                        if key in seen:
                            continue
                        seen.add(key)
                        self._walk_req(tfunc.body, trel, fields,
                                       depth - 1, seen)

    def arm_mutates(self, arm: _Arm, durable_attrs, mut_methods) -> bool:
        return self._walk_mut(arm.body, {"ft"}, durable_attrs,
                              mut_methods, _FOLLOW_DEPTH, set())

    def _walk_mut(self, body, aliases, attrs, mut_methods, depth, seen):
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id in aliases \
                        and node.func.attr in mut_methods:
                    return True
                if _mutates_attrs_node(node, attrs, aliases):
                    return True
            # follow helpers handed a store alias (e.g. _suggest_verb(ft,…))
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call) or depth <= 0:
                    continue
                positions = [i for i, a in enumerate(node.args)
                             if isinstance(a, ast.Name) and a.id in aliases]
                if not positions:
                    continue
                tail = _callee_tail(node)
                for trel, tfunc in self.methods.get(tail, ()):
                    key = (trel, tfunc.name)
                    if key in seen:
                        continue
                    seen.add(key)
                    params = [a.arg for a in tfunc.args.args]
                    if params and params[0] == "self":
                        params = params[1:]
                    sub_alias = {params[i] for i in positions
                                 if i < len(params)}
                    if sub_alias and self._walk_mut(
                            tfunc.body, sub_alias | self._store_aliases(
                                tfunc), attrs, mut_methods, depth - 1, seen):
                        return True
        return False


def _mutates_attrs_node(node, attrs, receivers) -> bool:
    """Store/delete/mutator-call on ``<recv>.<attr>`` for a durable attr."""
    def _hits(expr):
        return (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id in receivers and expr.attr in attrs)

    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if _hits(t):
                return True
            if isinstance(t, ast.Subscript) and _hits(t.value):
                return True
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and _hits(t.value):
                return True
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS and _hits(node.func.value):
        return True
    return False


def _mutates_attrs(func, attrs, receiver) -> bool:
    """Does ``func`` mutate one of ``attrs`` on ``receiver`` — directly
    or through a local aliasing a receiver-derived container?"""
    if func.name == "__init__":
        return False
    aliases = {receiver}
    for node in ast.walk(func):
        root_hits = any(
            isinstance(sub, ast.Attribute)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == receiver and sub.attr in attrs
            for sub in ast.walk(node))
        if isinstance(node, ast.Assign) and root_hits:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)
        elif isinstance(node, (ast.For, ast.comprehension)) and root_hits:
            t = node.target
            if isinstance(t, ast.Name):
                aliases.add(t.id)
    for node in ast.walk(func):
        if _mutates_attrs_node(node, attrs, {receiver}):
            return True
        # subscript-store / mutator call on an alias of durable state
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in aliases - {receiver}:
                    return True
    return False


def check(project) -> list:
    ext = _Extract(project)
    findings: list = []

    catalog_verbs = set(ext.other_catalog_verbs)
    for table in (ext.mutating, ext.idempotent, ext.wal, ext.readonly,
                  ext.framed, ext.control):
        for _rel, _line, verbs in table.values():
            catalog_verbs.update(verbs)

    # WP001 / WP002: both-direction site-level reconciliation
    if ext.arms:
        for site in ext.client_sites:
            if site.verb not in ext.arms:
                findings.append(Finding(
                    "WP001", site.rel, site.line, site.symbol,
                    f"client emits verb '{site.verb}' but no dispatcher "
                    f"arm handles it"))
    if ext.client_sites or catalog_verbs:
        emitted = {s.verb for s in ext.client_sites}
        for verb, arms in sorted(ext.arms.items()):
            if verb not in emitted and verb not in catalog_verbs:
                arm = arms[0]
                findings.append(Finding(
                    "WP002", arm.rel, arm.line, arm.symbol,
                    f"dispatcher handles verb '{verb}' but no client "
                    f"call site or *_VERBS catalog references it"))

    # WP003: required-field drift per verb
    required: dict[str, set] = {}
    for verb, arms in ext.arms.items():
        fields = set()
        for arm in arms:
            fields |= ext.arm_required_fields(arm)
        required[verb] = fields - _IMPLICIT_FIELDS
    for site in ext.client_sites:
        if site.has_star:
            continue
        missing = sorted(required.get(site.verb, set()) - site.kwargs)
        if missing:
            findings.append(Finding(
                "WP003", site.rel, site.line, site.symbol,
                f"verb '{site.verb}' call site omits required field(s) "
                f"{missing} the dispatcher reads with req[...]"))

    # Durable-state ground truth for WP004/WP005
    durable = ext.durable_classes()
    durable_attrs = set()
    for attrs in durable.values():
        durable_attrs |= attrs
    mut_methods = ext.mutating_methods(durable) if durable else set()
    server_mutating = set()
    if durable:
        for verb, arms in ext.arms.items():
            if any(ext.arm_mutates(arm, durable_attrs, mut_methods)
                   for arm in arms):
                server_mutating.add(verb)

    mutating_verbs = set()
    for _rel, _line, verbs in ext.mutating.values():
        mutating_verbs |= verbs
    idempotent_verbs = set()
    for _rel, _line, verbs in ext.idempotent.values():
        idempotent_verbs |= verbs
    wal_verbs = set()
    for _rel, _line, verbs in ext.wal.values():
        wal_verbs |= verbs

    # WP004: every mutating verb carries an idem key or is declared
    # retry-convergent.  The client attach is proven, not assumed.
    mutating_universe = wal_verbs | server_mutating
    if ext.mutating and mutating_universe:
        if not ext.idem_attach_proven:
            for name, (rel, line, _verbs) in sorted(ext.mutating.items()):
                findings.append(Finding(
                    "WP004", rel, line, name,
                    f"catalog {name} exists but no client code tests "
                    f"membership and stores kw['idem'] — the idempotency "
                    f"attach is unproven"))
        for verb in sorted(mutating_universe):
            if verb in mutating_verbs or verb in idempotent_verbs:
                continue
            if verb in ext.arms:
                arm = min(ext.arms[verb], key=lambda a: (a.rel, a.line))
                rel, line, sym = arm.rel, arm.line, f"{arm.symbol}:{verb}"
            else:
                name = sorted(ext.wal)[0]
                rel, line, _v = ext.wal[name]
                sym = f"{name}:{verb}"
            findings.append(Finding(
                "WP004", rel, line, sym,
                f"mutating verb '{verb}' reaches the wire with no "
                f"idempotency key: not in *_MUTATING_VERBS (client "
                f"auto-attach) and not declared retry-convergent in "
                f"*_IDEMPOTENT_VERBS"))

    # WP005: *_WAL_VERBS == the arms that actually mutate durable state
    if durable and ext.wal:
        for name, (rel, line, verbs) in sorted(ext.wal.items()):
            for verb in sorted(verbs):
                if verb in ext.arms and verb not in server_mutating:
                    findings.append(Finding(
                        "WP005", rel, line, f"{name}:{verb}",
                        f"'{verb}' is WAL-logged but its dispatcher arm "
                        f"never mutates durable store state — replay "
                        f"re-executes a read"))
        for verb in sorted(server_mutating - wal_verbs):
            arm = min(ext.arms[verb], key=lambda a: (a.rel, a.line))
            findings.append(Finding(
                "WP005", arm.rel, arm.line, f"{arm.symbol}:{verb}",
                f"verb '{verb}' mutates durable store state but is in no "
                f"*_WAL_VERBS catalog — the mutation survives no crash"))

    # WP006: catalog hygiene for the idempotency declarations
    if ext.idempotent:
        for name, (rel, line, verbs) in sorted(ext.idempotent.items()):
            for verb in sorted(verbs & mutating_verbs):
                findings.append(Finding(
                    "WP006", rel, line, f"{name}:{verb}",
                    f"'{verb}' is declared both retry-convergent "
                    f"({name}) and idempotency-keyed (*_MUTATING_VERBS) "
                    f"— pick one"))
            if mutating_universe:
                for verb in sorted(verbs - mutating_universe):
                    findings.append(Finding(
                        "WP006", rel, line, f"{name}:{verb}",
                        f"'{verb}' is declared retry-convergent in {name} "
                        f"but is not a mutating verb — stale declaration"))

    # WP006, control catalogs: directives that touch no durable state
    for name, (rel, line, verbs) in sorted(ext.control.items()):
        for verb in sorted(verbs):
            if verb in mutating_verbs or verb in idempotent_verbs:
                findings.append(Finding(
                    "WP006", rel, line, f"{name}:{verb}",
                    f"'{verb}' is declared a control verb ({name}) and "
                    f"also mutating/retry-convergent in another catalog "
                    f"— the declarations contradict"))
            elif verb in server_mutating:
                findings.append(Finding(
                    "WP006", rel, line, f"{name}:{verb}",
                    f"'{verb}' is declared a control verb ({name}) but "
                    f"its dispatcher arm mutates durable store state — "
                    f"stale declaration"))
            elif ext.arms and verb not in ext.arms:
                findings.append(Finding(
                    "WP006", rel, line, f"{name}:{verb}",
                    f"control verb '{verb}' ({name}) has no dispatcher "
                    f"arm — stale declaration"))

    # WP007: the lock-free read path serves exactly verbs that touch no
    # durable state and answer to no other catalog's contract.
    if ext.readonly:
        conflicting = wal_verbs | mutating_verbs | idempotent_verbs
        for name, (rel, line, verbs) in sorted(ext.readonly.items()):
            for verb in sorted(verbs):
                if verb in server_mutating:
                    findings.append(Finding(
                        "WP007", rel, line, f"{name}:{verb}",
                        f"'{verb}' is declared read-only ({name}) but its "
                        f"dispatcher arm mutates durable store state — "
                        f"served off the write lock it races every writer"))
                elif verb in conflicting:
                    findings.append(Finding(
                        "WP007", rel, line, f"{name}:{verb}",
                        f"'{verb}' is declared read-only ({name}) and also "
                        f"mutating/WAL-logged/retry-convergent in another "
                        f"catalog — the declarations contradict"))
                elif verb not in ext.arms:
                    findings.append(Finding(
                        "WP007", rel, line, f"{name}:{verb}",
                        f"read-only verb '{verb}' has no dispatcher arm — "
                        f"stale catalog entry"))

    # WP008: binary-framed verbs round-trip through the shared codec
    # fixtures in both directions, and the fixture set never goes stale.
    if ext.framed:
        framed_all = set()
        for name, (rel, line, verbs) in sorted(ext.framed.items()):
            framed_all |= verbs
            for verb in sorted(verbs):
                if verb not in ext.arms:
                    findings.append(Finding(
                        "WP008", rel, line, f"{name}:{verb}",
                        f"framed verb '{verb}' has no dispatcher arm — a "
                        f"frame-encoded request has nowhere to decode"))
                fx = ext.codec_fixtures.get(verb)
                if fx is None:
                    findings.append(Finding(
                        "WP008", rel, line, f"{name}:{verb}",
                        f"framed verb '{verb}' has no CODEC_FIXTURES "
                        f"entry — nothing pins its encode↔decode "
                        f"round-trip"))
                elif not (fx[2] and fx[3]):
                    missing = [d for d, got in (("req", fx[2]),
                                                ("reply", fx[3])) if not got]
                    findings.append(Finding(
                        "WP008", fx[0], fx[1], f"CODEC_FIXTURES:{verb}",
                        f"fixture for framed verb '{verb}' lacks "
                        f"{missing} — both directions (client encode ↔ "
                        f"server decode) must round-trip"))
        for verb, (rel, line, _rq, _rp) in sorted(
                ext.codec_fixtures.items()):
            if verb not in framed_all:
                findings.append(Finding(
                    "WP008", rel, line, f"CODEC_FIXTURES:{verb}",
                    f"fixture '{verb}' names a verb no *FRAMED_VERBS "
                    f"catalog declares — stale fixture"))
    return findings
