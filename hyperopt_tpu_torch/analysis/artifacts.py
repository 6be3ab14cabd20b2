"""AH — artifact honesty: every JSON-writing script has a schema guard.

The port's measurement scripts stand at the repository root
(``chip_smoke.py``, whose last lines are the JSON records a reader of
a chip run parses, and ``chip_ei_ab.py``, which writes ``ei_ab.json``);
the package itself writes only data and state (traces, WAL, bundles),
which its own tests read back.

AH001  A root-level script that serializes JSON (``json.dump`` /
       ``json.dumps``) has no named schema guard in
       ``tests/test_torch_artifacts.py`` — its artifact shape can drift
       silently and its readers find out at read time.  A guard counts
       when the guard test mentions the script's stem anywhere (test
       name, artifact filename).  No entry is grandfathered.
"""

from __future__ import annotations

import ast

from .core import Finding, dotted_name

RULES = ("AH001",)

_CONTRACT = "tests/test_torch_artifacts.py"


def _writes_json(tree: ast.Module) -> int:
    """Line of the first json.dump/json.dumps call, else 0."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.split(".")[-1] in ("dump", "dumps") and \
                    name.split(".")[0] == "json":
                return node.lineno
    return 0


def check(project) -> list:
    findings: list = []
    contract = project.file_text(_CONTRACT)
    for rel, module in sorted(project.modules.items()):
        if "/" in rel or not rel.endswith(".py"):
            continue
        line = _writes_json(module.tree)
        if not line:
            continue
        stem = rel.rsplit("/", 1)[-1][:-3]
        if stem not in contract:
            findings.append(Finding(
                "AH001", rel, line, stem,
                f"script writes a JSON artifact but {_CONTRACT} has "
                f"no schema guard mentioning '{stem}'"))
    return findings
