"""Import-free static-analysis core: projects, findings, baselines.

Everything in ``hyperopt_tpu_torch.analysis`` works on **source text
and ``ast`` trees only** — the analyzed modules are never imported, so
the suite runs on a machine without torch (or CUDA) and cannot be
skewed by import-time side effects (kernel builds, device probes,
cache warmups).  ``tests/test_torch_analysis.py`` pins this: no module
in this package imports anything outside the stdlib.

The unit of work is a :class:`Project`: a set of parsed Python modules
(keyed by repo-relative posix path) plus raw text files the checkers
cross-reference (the port's catalog ``hyperopt_tpu_torch/analysis/
CATALOG.md``, ``docs/API.md`` read-only, the artifacts guard test).
Build one from a repo checkout with :func:`Project.from_dir` or from
in-memory sources with :func:`Project.from_sources` (how the fixture
tests feed one known violation per rule).

Findings are matched against a checked-in, annotated baseline on
``(rule, file, symbol)`` — line numbers drift with every edit, the
enclosing symbol does not.  The contract is burn-down, not suppression:
a baseline entry whose finding disappeared is *stale* and fails the
gate just like a new finding, so fixes must delete their entry.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

__all__ = [
    "Finding",
    "Module",
    "Project",
    "Baseline",
    "dotted_name",
    "call_func_name",
    "qualified_functions",
]


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file / line / enclosing symbol."""

    rule: str          # e.g. "JP001"
    file: str          # repo-relative posix path
    line: int          # 1-based, best effort
    symbol: str        # enclosing function/class qualname, or "<module>"
    message: str       # human-readable statement of the violation

    def key(self):
        return (self.rule, self.file, self.symbol)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "symbol": self.symbol, "message": self.message}

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule} [{self.symbol}] "
                f"{self.message}")


@dataclass
class Module:
    """One parsed source module."""

    rel: str           # repo-relative posix path
    text: str
    tree: ast.Module = field(repr=False)

    @classmethod
    def parse(cls, rel: str, text: str) -> "Module":
        return cls(rel=rel, text=text, tree=ast.parse(text, filename=rel))


class Project:
    """Parsed modules + reference text files for one analysis run."""

    #: Analyzed package prefix (checkers scope rules to it).
    package = "hyperopt_tpu_torch/"
    #: The port's root scripts: parsed beside the package (the artifact
    #: and capture-purity rules cover them; the package-scoped rules do
    #: not).
    scripts = ("chip_smoke.py", "chip_ei_ab.py", "graft_entry_torch.py")
    #: Text files the checkers read: the port's own catalog, the JAX
    #: package's API reference (read-only: the names the port keeps) and
    #: the test holding the port's artifact schema guards.
    catalog = "hyperopt_tpu_torch/analysis/CATALOG.md"
    reference_files = (catalog, "docs/API.md",
                       "tests/test_torch_artifacts.py")

    def __init__(self, modules, files=None, root=None):
        self.modules: dict = {m.rel: m for m in modules}
        self.files: dict = dict(files or {})   # rel -> raw text (non-py)
        self.root = root

    # -- construction --------------------------------------------------------

    @classmethod
    def from_dir(cls, root: str) -> "Project":
        """Parse the package and the root scripts, and read the reference
        files, from a repo checkout.  ``hyperopt_tpu_torch/analysis/`` is
        excluded from its own jurisdiction — the tool's rule tables would
        otherwise feed the registry scans."""
        root = os.path.abspath(root)
        pkg = cls.package.rstrip("/")
        paths = []
        base = os.path.join(root, pkg)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__"
                and not (dirpath == base and d == "analysis"))
            paths.extend(os.path.join(dirpath, fn)
                         for fn in sorted(filenames) if fn.endswith(".py"))
        paths.extend(os.path.join(root, s) for s in cls.scripts)
        modules, files = [], {}
        for path in paths:
            if not os.path.exists(path):
                continue
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                text = f.read()
            try:
                modules.append(Module.parse(rel, text))
            except SyntaxError:
                # A syntactically broken module is someone else's build
                # failure; skip rather than crash the gate.
                continue
        for rel in cls.reference_files:
            path = os.path.join(root, rel)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    files[rel] = f.read()
        return cls(modules, files=files, root=root)

    @classmethod
    def from_sources(cls, sources: dict, files=None) -> "Project":
        """Build from ``{rel_path: source_text}`` (fixture tests)."""
        return cls([Module.parse(rel, text)
                    for rel, text in sorted(sources.items())],
                   files=files)

    # -- access --------------------------------------------------------------

    def package_modules(self):
        """Modules under the analyzed package, sorted by path."""
        return [m for rel, m in sorted(self.modules.items())
                if rel.startswith(self.package)]

    def script_modules(self):
        """The root scripts that were parsed, in :attr:`scripts` order."""
        return [self.modules[rel] for rel in self.scripts
                if rel in self.modules]

    def module(self, rel: str):
        return self.modules.get(rel)

    def file_text(self, rel: str) -> str:
        return self.files.get(rel, "")


class Baseline:
    """Annotated findings the gate tolerates (burn-down list).

    JSON form::

        {"version": 1,
         "entries": [{"rule": "...", "file": "...", "symbol": "...",
                      "note": "why this is baselined, not fixed"}]}

    Every entry MUST carry a non-empty ``note`` — an unannotated
    suppression is itself an error (`validate`).
    """

    def __init__(self, entries=None, path=None):
        self.entries = list(entries or [])
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(entries=[], path=path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return cls(entries=doc.get("entries", []), path=path)

    def validate(self):
        """Return a list of error strings for malformed entries."""
        errs = []
        for i, e in enumerate(self.entries):
            missing = [k for k in ("rule", "file", "symbol") if not e.get(k)]
            if missing:
                errs.append(f"baseline entry {i}: missing {missing}")
            if not str(e.get("note", "")).strip():
                errs.append(
                    f"baseline entry {i} ({e.get('rule')} {e.get('file')} "
                    f"{e.get('symbol')}): empty 'note' — annotate why this "
                    "finding is tolerated")
        return errs

    def keys(self):
        return {(e["rule"], e["file"], e["symbol"]) for e in self.entries
                if e.get("rule") and e.get("file") and e.get("symbol")}

    def match(self, findings):
        """Split ``findings`` → (new, baselined) and compute stale entries.

        Returns ``(new_findings, baselined_findings, stale_entries)``.
        """
        keys = self.keys()
        hit = set()
        new, old = [], []
        for f in findings:
            if f.key() in keys:
                hit.add(f.key())
                old.append(f)
            else:
                new.append(f)
        stale = [e for e in self.entries
                 if (e.get("rule"), e.get("file"), e.get("symbol"))
                 not in hit]
        return new, old, stale

    @staticmethod
    def render(findings, notes=None) -> dict:
        """Serialize ``findings`` into baseline-document form (used by
        ``--write-baseline``); ``notes`` maps keys to annotations."""
        notes = notes or {}
        entries, seen = [], set()
        for f in sorted(findings, key=lambda f: (f.rule, f.file, f.symbol)):
            if f.key() in seen:
                continue
            seen.add(f.key())
            entries.append({
                "rule": f.rule, "file": f.file, "symbol": f.symbol,
                "note": notes.get(f.key(), "TODO: annotate or fix"),
            })
        return {"version": 1, "entries": entries}


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_func_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def qualified_functions(tree: ast.Module):
    """Yield ``(qualname, func_node, class_name_or_None)`` for every
    function: top-level defs and class methods (one nesting level of
    classes; nested defs stay inside their parent's body walk)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node, None
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub, node.name


def str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def joined_str_prefix(node) -> str | None:
    """Literal prefix of an f-string up to its first placeholder, with a
    trailing ``*`` wildcard (``f"faults.injected.{p}"`` → ``faults.injected.*``)."""
    if not isinstance(node, ast.JoinedStr):
        return None
    prefix = []
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            prefix.append(part.value)
        else:
            break
    return "".join(prefix) + "*"
