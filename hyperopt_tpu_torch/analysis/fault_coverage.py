"""FP — fault-point coverage: chaos can reach every wire and WAL edge.

The failover proofs of the service tier are only as strong as the fault
schedule's reach: an RPC or durable-append code path with no
``faults.maybe_fail`` hook is a path the chaos harness can never
exercise, so its failure handling is permanently untested.  RD003/
RD004 already reconcile hook *names* against the ``FAULT_POINTS``
catalog; this rule closes the other direction — the *sites* that must
carry a hook at all.

FP001  A function that performs wire I/O (calls ``urlopen`` or checks
       out the pooled transport via ``_rpc_pool``) or the durable WAL
       append (an ``append`` method in a module naming the
       ``wal.jsonl`` log) contains no ``maybe_fail(...)`` hook — fault
       injection cannot reach this network/durability edge.  The pool's
       own internals are exempt: the *call sites* carry the hooks, so
       one hook guards every transport however many sockets it cycles.
"""

from __future__ import annotations

import ast

from .core import Finding, call_func_name, qualified_functions, str_const

RULES = ("FP001",)

_WAL_LOG = "wal.jsonl"


def _module_names_wal(tree) -> bool:
    for node in ast.walk(tree):
        s = str_const(node)
        if s is not None and _WAL_LOG in s:
            return True
    return False


def check(project) -> list:
    findings: list = []
    for module in project.package_modules():
        rel = module.rel
        is_wal_module = _module_names_wal(module.tree)
        for qual, func, _cls in qualified_functions(module.tree):
            does_io_line = 0
            kind = None
            has_hook = False
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                tail = (call_func_name(node) or "").rsplit(".", 1)[-1]
                if tail == "urlopen" and not does_io_line:
                    does_io_line, kind = node.lineno, "wire I/O (urlopen)"
                elif tail == "_rpc_pool" and not does_io_line:
                    does_io_line, kind = node.lineno, \
                        "wire I/O (pooled transport)"
                elif tail == "maybe_fail" and node.args \
                        and str_const(node.args[0]):
                    has_hook = True
            if is_wal_module and qual.rsplit(".", 1)[-1] == "append" \
                    and not does_io_line:
                does_io_line, kind = func.lineno, "the durable WAL append"
            if does_io_line and not has_hook:
                findings.append(Finding(
                    "FP001", rel, does_io_line, qual,
                    f"{kind} with no maybe_fail hook — fault injection "
                    f"cannot reach this edge; add a cataloged fault "
                    f"point"))
    return findings
