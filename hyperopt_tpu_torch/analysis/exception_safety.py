"""ES — exception safety in the threaded layers: failures must either
release, surface, or not start under a lock.

Fault injection (faults.py) can prove the *handled* failure paths; it
cannot see the failure modes where the error never surfaces — a lock
left held after an exception, a daemon thread swallowing its own death,
a thread spun up while its creator still holds the lock the new thread
will immediately want.  These are the bugs with multi-hour debugging
tails because the process looks healthy.

ES001  Manual ``lock.acquire()`` with no try/finally ``release()`` —
       any exception between the two leaves the lock held forever.
       ``with lock:`` is the idiom; a bare acquire is only tolerated as
       the statement immediately before (or inside) a ``try`` whose
       ``finally`` releases the same lock.
ES002  A broad ``except``/``except Exception`` inside a thread-entry
       function (or anything it calls, same module) that neither
       re-raises nor surfaces (logging/print/metrics) — the daemon dies
       or degrades silently and fault injection never sees it.
ES003  A thread started while holding a lock — directly
       (``Thread(...).start()``) or by constructing a class whose
       ``__init__`` starts one.  The new thread's first lock
       acquisition races its creator's critical section; if the creator
       ever blocks on the child, it deadlocks.

Thread-entry functions are found structurally: any function referenced
as ``target=`` in a ``threading.Thread(...)`` call, the function
containing that call when the target is a nested def, and their
same-module transitive callees.  Surfacing calls are attribute calls
named ``exception``/``error``/``warning``/``critical``/``info``/
``debug``/``log``, bare ``print``, or metric emissions (``.inc``/
``.set``/``.observe``).
"""

from __future__ import annotations

import ast

from .core import (Finding, call_func_name, dotted_name,
                   qualified_functions)

RULES = ("ES001", "ES002", "ES003")

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                         "BoundedSemaphore"})
_SURFACE_TAILS = frozenset({"exception", "error", "warning", "warn",
                            "critical", "info", "debug", "log", "print",
                            "inc", "set", "observe"})


def _lockish_name(expr) -> str | None:
    """A name that denotes a lock: ``self._lock``-style attributes or
    bare names containing 'lock'/'cv'/'cond'."""
    if isinstance(expr, ast.Attribute):
        if "lock" in expr.attr.lower() or expr.attr.lower() in (
                "cv", "cond"):
            return "." + expr.attr
        return None
    if isinstance(expr, ast.Name):
        low = expr.id.lower()
        if "lock" in low or low in ("cv", "cond"):
            return expr.id
        return None
    return None


def _lock_attrs(tree) -> set:
    """self attributes assigned a threading lock anywhere in the module
    (plus module-level lock names) — extends the name heuristic so
    ``self._gate = threading.Lock()`` counts even without 'lock' in the
    name."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = (call_func_name(node.value) or "").rsplit(".", 1)[-1]
            if ctor not in _LOCK_CTORS:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    out.add("." + t.attr)
                elif isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _release_targets(stmts) -> set:
    out = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "release":
                name = _lockish_name(node.func.value)
                if name is None and isinstance(node.func.value,
                                               ast.Attribute):
                    name = "." + node.func.value.attr
                elif name is None and isinstance(node.func.value, ast.Name):
                    name = node.func.value.id
                if name:
                    out.add(name)
    return out


def _acquire_name(stmt, known_locks) -> tuple | None:
    """(lock_name, line) if the statement's top-level expression is an
    ``acquire()`` call on a lock."""
    expr = None
    if isinstance(stmt, ast.Expr):
        expr = stmt.value
    elif isinstance(stmt, ast.Assign):
        expr = stmt.value
    if not (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "acquire"):
        return None
    recv = expr.func.value
    name = _lockish_name(recv)
    if name is None:
        if isinstance(recv, ast.Attribute):
            name = "." + recv.attr
        elif isinstance(recv, ast.Name):
            name = recv.id
        if name not in known_locks:
            return None
    return name, expr.lineno


def _check_acquires(func, rel, qual, known_locks, findings):
    def scan(body):
        for i, stmt in enumerate(body):
            got = _acquire_name(stmt, known_locks)
            if got is not None:
                name, line = got
                ok = False
                nxt = body[i + 1] if i + 1 < len(body) else None
                if isinstance(nxt, ast.Try) \
                        and name in _release_targets(nxt.finalbody):
                    ok = True
                if not ok:
                    findings.append(Finding(
                        "ES001", rel, line, qual,
                        f"manual {name}.acquire() with no try/finally "
                        f"release — an exception leaves the lock held; "
                        f"use 'with'"))
            if isinstance(stmt, ast.Try):
                released = _release_targets(stmt.finalbody)
                # acquires inside try-with-finally-release are fine
                for j, sub in enumerate(stmt.body):
                    got = _acquire_name(sub, known_locks)
                    if got is not None and got[0] not in released:
                        findings.append(Finding(
                            "ES001", rel, got[1], qual,
                            f"manual {got[0]}.acquire() with no "
                            f"try/finally release — an exception leaves "
                            f"the lock held; use 'with'"))
                for sub in stmt.body:
                    for blk in _sub_blocks(sub):
                        scan(blk)
                for h in stmt.handlers:
                    scan(h.body)
                scan(stmt.orelse)
                scan(stmt.finalbody)
                continue
            for blk in _sub_blocks(stmt):
                scan(blk)

    scan(func.body)


def _sub_blocks(stmt):
    for attr in ("body", "orelse", "finalbody"):
        blk = getattr(stmt, attr, None)
        if blk and not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
            yield blk
    for h in getattr(stmt, "handlers", ()):
        yield h.body


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [dotted_name(e) or "" for e in t.elts]
    else:
        names = [dotted_name(t) or ""]
    return any(n.rsplit(".", 1)[-1] in ("Exception", "BaseException")
               for n in names)


def _handler_surfaces(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            tail = node.func.attr if isinstance(node.func, ast.Attribute) \
                else ((call_func_name(node) or "").rsplit(".", 1)[-1])
            if tail in _SURFACE_TAILS:
                return True
        # ``except Exception as e: queue.put((.., e))`` marshals the
        # exception onward — the failure is someone else's to surface.
        if handler.name and isinstance(node, ast.Name) \
                and node.id == handler.name \
                and isinstance(node.ctx, ast.Load):
            return True
    return False


def _thread_entry_functions(tree) -> set:
    """Names of functions that run on (or start) daemon threads: every
    ``target=`` reference, plus the containing function when the target
    is a nested def (the handler scan covers the whole lexical scope)."""
    entries = set()
    funcs = list(qualified_functions(tree))
    for qual, func, _cls in funcs:
        for node in ast.walk(func):
            if not (isinstance(node, ast.Call)
                    and (call_func_name(node) or "").rsplit(
                        ".", 1)[-1] == "Thread"):
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                tname = (dotted_name(kw.value) or "").rsplit(".", 1)[-1]
                if not tname:
                    continue
                nested = {d.name for d in ast.walk(func)
                          if isinstance(d, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and d is not func}
                if tname in nested:
                    entries.add(qual)       # scan the enclosing scope
                else:
                    entries.add(tname)
    # close over same-module calls from entry functions
    by_name: dict[str, list] = {}
    for qual, func, _cls in funcs:
        by_name.setdefault(qual.rsplit(".", 1)[-1], []).append(qual)
        by_name.setdefault(qual, []).append(qual)
    calls: dict[str, set] = {}
    for qual, func, _cls in funcs:
        out = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                tail = (call_func_name(node) or "").rsplit(".", 1)[-1]
                if tail:
                    out.update(by_name.get(tail, ()))
        calls[qual] = out
    changed = True
    while changed:
        changed = False
        for qual, out in calls.items():
            short = qual.rsplit(".", 1)[-1]
            if qual in entries or short in entries:
                fresh = out - entries
                if fresh:
                    entries.update(fresh)
                    changed = True
    return entries


def _thread_starting_classes(project) -> set:
    """Class names whose ``__init__`` starts a thread."""
    out = set()
    for module in project.package_modules():
        rel = module.rel
        for node in module.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) \
                        and sub.name == "__init__" \
                        and _starts_thread(sub):
                    out.add(node.name)
    return out


def _starts_thread(func) -> bool:
    thread_names = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and (call_func_name(node.value) or "").rsplit(
                    ".", 1)[-1] == "Thread":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    thread_names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    thread_names.add("." + t.attr)
    for node in ast.walk(func):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "start"):
            continue
        recv = node.func.value
        if isinstance(recv, ast.Call) and (call_func_name(recv) or "") \
                .rsplit(".", 1)[-1] == "Thread":
            return True
        if isinstance(recv, ast.Name) and recv.id in thread_names:
            return True
        if isinstance(recv, ast.Attribute) \
                and "." + recv.attr in thread_names:
            return True
    return False


def _check_starts_under_lock(func, rel, qual, known_locks,
                             thread_classes, findings):
    thread_locals = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call):
            tail = (call_func_name(node.value) or "").rsplit(".", 1)[-1]
            if tail == "Thread":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        thread_locals.add(t.id)

    def scan(body, held):
        for stmt in body:
            if isinstance(stmt, ast.With):
                locks = []
                for item in stmt.items:
                    name = _lockish_name(item.context_expr)
                    if name is None:
                        ce = item.context_expr
                        if isinstance(ce, ast.Attribute) \
                                and "." + ce.attr in known_locks:
                            name = "." + ce.attr
                        elif isinstance(ce, ast.Name) \
                                and ce.id in known_locks:
                            name = ce.id
                    if name:
                        locks.append(name)
                scan(stmt.body, held + locks)
                continue
            if held:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    if isinstance(node.func, ast.Attribute) \
                            and node.func.attr == "start":
                        recv = node.func.value
                        started = (
                            (isinstance(recv, ast.Call)
                             and (call_func_name(recv) or "").rsplit(
                                 ".", 1)[-1] == "Thread")
                            or (isinstance(recv, ast.Name)
                                and recv.id in thread_locals))
                        if started:
                            findings.append(Finding(
                                "ES003", rel, node.lineno, qual,
                                f"thread started while holding "
                                f"{held[-1]} — the child's first lock "
                                f"acquisition races this critical "
                                f"section"))
                    else:
                        ctor = call_func_name(node) or ""
                        if ctor.rsplit(".", 1)[-1] in thread_classes:
                            findings.append(Finding(
                                "ES003", rel, node.lineno, qual,
                                f"{ctor}() starts a thread in __init__ "
                                f"while {held[-1]} is held — construct "
                                f"outside the lock, publish under it"))
            for blk in _sub_blocks(stmt):
                scan(blk, held)

    scan(func.body, [])


def check(project) -> list:
    findings: list = []
    thread_classes = _thread_starting_classes(project)
    for module in project.package_modules():
        rel = module.rel
        tree = module.tree
        known_locks = _lock_attrs(tree)
        entries = _thread_entry_functions(tree)
        for qual, func, _cls in qualified_functions(tree):
            _check_acquires(func, rel, qual, known_locks, findings)
            _check_starts_under_lock(func, rel, qual, known_locks,
                                     thread_classes, findings)
            short = qual.rsplit(".", 1)[-1]
            if qual in entries or short in entries:
                for node in ast.walk(func):
                    if isinstance(node, ast.ExceptHandler) \
                            and _is_broad_handler(node) \
                            and not _handler_surfaces(node):
                        findings.append(Finding(
                            "ES002", rel, node.lineno, qual,
                            "broad except swallows silently inside a "
                            "thread-entry path — the daemon degrades "
                            "with no trace; log, count, or re-raise"))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
