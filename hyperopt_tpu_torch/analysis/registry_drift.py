"""RD — name-registry coherence between the port's source and catalogs.

Five registries, each checked in both directions.  The catalog is the
port's own ``hyperopt_tpu_torch/analysis/CATALOG.md``; ``docs/API.md``
(the JAX package's reference, read-only) also counts for a name the
source uses, since the port keeps most of its names, but only the
port's catalog is held to the source the other way.

* env vars     string literals read through ``os.environ`` (``.get``,
               ``[...]``, ``in``, ``.setdefault``, ``.pop``) or
               ``os.getenv`` in source vs the back-ticked names of the
               catalog's Environment section.  Any name counts: the
               port reads a handful of general variables and no switch
               of its own.
               RD001 read-but-uncataloged · RD002 cataloged-but-unread
* fault points first args of ``maybe_fail()`` calls and the
               ``FAULT_POINTS`` frozenset in faults.py vs the catalog.
               RD003 injected-point-not-in-FAULT_POINTS ·
               RD004 FAULT_POINTS-entry-not-in-catalog
* service verbs ``self._rpc("X")`` client literals and ``*_VERBS``
               frozensets vs the ``verb == "X"`` dispatcher arms.
               RD005 referenced-but-no-dispatch-arm ·
               RD008 dispatch-arm-never-referenced
* obs metrics  ``.counter/.gauge/.histogram("name")`` emission literals
               (f-strings become ``prefix*`` wildcards) vs the dotted
               names back-ticked in the catalog's Observability sections
               (``<placeholder>`` segments become ``*``).
               RD006 emitted-but-uncataloged · RD007 cataloged-but-unemitted
* SLO names    ``SloSpec("name", ...)`` declarations in source vs the
               concrete ``slo.<name>.{firing,burn_fast,burn_slow,value}``
               gauge tokens back-ticked in the catalog.  The suffix
               restriction keeps the ``slo.alerts.fired`` counters from
               reading as a declared SLO called "alerts".
               RD009 declared-but-uncataloged · RD010 cataloged-but-undeclared

All extraction is AST / text based — nothing is imported, so a metric
emitted behind a setter or a lazily-registered fault point is still
seen.  An environment read is a call or subscript, never prose, so
docstrings cannot feed RD001.  Doc tokens only count as *metric*
catalog entries when their first dotted segment matches some emitted
metric's first segment; this keeps module paths and config keys out of
RD007 at the cost of missing a catalog section whose whole subsystem
was deleted (which RD004 would catch via its fault points anyway).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, dotted_name, joined_str_prefix, str_const

RULES = ("RD001", "RD002", "RD003", "RD004",
         "RD005", "RD006", "RD007", "RD008", "RD009", "RD010")

_ENV_DOC_RE = re.compile(r"`([A-Z][A-Z0-9_]*)`")
_ENV_CALLS = ("environ.get", "environ.setdefault", "environ.pop", "getenv")
_DOC_TOKEN_RE = re.compile(r"`([a-z][a-z0-9_]*(?:\.[a-z0-9_.<>*-]+)+)`")
_EMITTERS = {"counter", "gauge", "histogram"}
_NONMETRIC_SUFFIXES = (".py", ".md", ".json", ".jsonl", ".txt", ".log")
_SLO_SUFFIXES = ("firing", "burn_fast", "burn_slow", "value")


def _doc_line(text: str, token: str) -> int:
    for i, line in enumerate(text.splitlines(), 1):
        if token in line:
            return i
    return 1


def _is_environ(node) -> bool:
    name = dotted_name(node) or ""
    return name == "environ" or name.endswith(".environ")


def _env_read(node) -> str | None:
    """The variable an ``os.environ``/``os.getenv`` read names, else None."""
    if isinstance(node, ast.Call) and node.args:
        name = dotted_name(node.func) or ""
        if name.endswith(_ENV_CALLS):
            return str_const(node.args[0])
    elif isinstance(node, ast.Subscript) and _is_environ(node.value):
        return str_const(node.slice)
    elif isinstance(node, ast.Compare) and len(node.ops) == 1 and \
            isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
            _is_environ(node.comparators[0]):
        return str_const(node.left)
    return None


def _section(text: str, word: str) -> str:
    """Lines under the headings whose title holds ``word``."""
    out, keep = [], False
    for line in text.splitlines():
        if line.startswith("#"):
            keep = word in line.lower()
        if keep:
            out.append(line)
    return "\n".join(out)


def _wild_match(a: str, b: str) -> bool:
    """Match two names where either may carry ``*`` wildcards."""
    if "*" not in a and "*" not in b:
        return a == b
    pa, pb = a.split("*", 1)[0], b.split("*", 1)[0]
    return pa.startswith(pb) or pb.startswith(pa)


def _literal_set(node) -> set:
    """String elements of a set/frozenset/tuple/list literal expression."""
    out = set()
    if isinstance(node, ast.Call) and node.args:
        name = dotted_name(node.func)
        if name and name.split(".")[-1] in ("frozenset", "set", "tuple"):
            node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        for el in node.elts:
            s = str_const(el)
            if s:
                out.add(s)
    return out


class _Extract:
    """One pass over every module: all four registries' source side."""

    def __init__(self, project):
        self.env: dict = {}            # name -> (file, line)
        self.fault_sites: dict = {}    # point -> (file, line)
        self.fault_points: set = set()
        self.fault_file = "hyperopt_tpu_torch/faults.py"
        self.client_verbs: dict = {}   # verb -> (file, line)
        self.dispatch_verbs: dict = {} # verb -> (file, line)
        self.metrics: dict = {}        # name/pattern -> (file, line)
        self.slo_specs: dict = {}      # SLO name -> (file, line)
        for module in project.package_modules():
            self._scan(module)

    def _scan(self, module):
        rel = module.rel
        for node in ast.walk(module.tree):
            env = _env_read(node)
            if env:
                self.env.setdefault(env, (rel, node.lineno))
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func) or ""
            tail = fname.split(".")[-1]
            if tail == "maybe_fail" and node.args:
                point = str_const(node.args[0])
                if point:
                    self.fault_sites.setdefault(point, (rel, node.lineno))
            elif tail == "_rpc" and node.args:
                verb = str_const(node.args[0])
                if verb:
                    self.client_verbs.setdefault(verb, (rel, node.lineno))
            elif tail == "SloSpec":
                name = str_const(node.args[0]) if node.args else None
                if name is None:
                    for kw in node.keywords:
                        if kw.arg == "name":
                            name = str_const(kw.value)
                if name:
                    self.slo_specs.setdefault(name, (rel, node.lineno))
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _EMITTERS and node.args:
                # matches both reg.counter("x") and registry().counter("x")
                # (dotted_name cannot resolve a Call base)
                name = str_const(node.args[0]) or \
                    joined_str_prefix(node.args[0])
                if name:
                    self.metrics.setdefault(name, (rel, node.lineno))
        # FAULT_POINTS / *_VERBS literal sets (module or class scope)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                tname = tgt.id if isinstance(tgt, ast.Name) else None
                if not tname:
                    continue
                if tname == "FAULT_POINTS":
                    self.fault_points |= _literal_set(node.value)
                    self.fault_file = rel
                elif tname.endswith("_VERBS"):
                    for v in _literal_set(node.value):
                        self.client_verbs.setdefault(v, (rel, node.lineno))
        # dispatcher arms: verb == "X" comparisons anywhere in the module
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Compare) and \
                    isinstance(node.left, ast.Name) and \
                    node.left.id == "verb" and \
                    all(isinstance(op, ast.Eq) for op in node.ops):
                for comp in node.comparators:
                    v = str_const(comp)
                    if v:
                        self.dispatch_verbs.setdefault(
                            v, (rel, node.lineno))


def check(project) -> list:
    findings: list = []
    ext = _Extract(project)
    cat_rel = project.catalog
    catalog_text = project.file_text(cat_rel)
    # names the source uses may stand in either text; only the port's
    # catalog is held to the source the other way
    known = catalog_text + "\n" + project.file_text("docs/API.md")

    # RD001 / RD002 — env vars
    cat_env = set(_ENV_DOC_RE.findall(_section(catalog_text,
                                               "environment")))
    for name, (rel, line) in sorted(ext.env.items()):
        if name not in cat_env:
            findings.append(Finding(
                "RD001", rel, line, name,
                f"env var {name} is read in source but missing from the "
                f"{cat_rel} catalog"))
    for name in sorted(cat_env - set(ext.env)):
        findings.append(Finding(
            "RD002", cat_rel, _doc_line(catalog_text, name), name,
            f"env var {name} is cataloged in {cat_rel} but never read "
            "in source"))

    # RD003 / RD004 — fault points
    for point, (rel, line) in sorted(ext.fault_sites.items()):
        if ext.fault_points and point not in ext.fault_points:
            findings.append(Finding(
                "RD003", rel, line, point,
                f"maybe_fail point '{point}' is not in faults.FAULT_POINTS"))
    for point in sorted(ext.fault_points):
        if f"`{point}`" not in known:
            findings.append(Finding(
                "RD004", cat_rel, 1, point,
                f"fault point '{point}' is in FAULT_POINTS but not "
                f"cataloged in {cat_rel}"))

    # RD005 / RD008 — service verbs
    for verb, (rel, line) in sorted(ext.client_verbs.items()):
        if ext.dispatch_verbs and verb not in ext.dispatch_verbs:
            findings.append(Finding(
                "RD005", rel, line, verb,
                f"verb '{verb}' is sent/cataloged by clients but has no "
                "dispatcher arm"))
    for verb, (rel, line) in sorted(ext.dispatch_verbs.items()):
        if ext.client_verbs and verb not in ext.client_verbs:
            findings.append(Finding(
                "RD008", rel, line, verb,
                f"dispatcher handles verb '{verb}' that no client or "
                "*_VERBS catalog references"))

    # RD006 / RD007 — obs metrics vs the Observability sections
    first_segs = {m.split(".")[0].rstrip("*") for m in ext.metrics}

    def metric_tokens(text):
        out = set()
        for tok in _DOC_TOKEN_RE.findall(_section(text, "observability")):
            if tok.endswith(_NONMETRIC_SUFFIXES) or tok in ext.fault_points:
                continue
            pat = re.sub(r"<[^>]*>", "*", tok)
            if pat.split(".")[0].split("*")[0] in first_segs:
                out.add(pat)
        return out

    catalog = metric_tokens(catalog_text)
    known_metrics = catalog | metric_tokens(known)
    for name, (rel, line) in sorted(ext.metrics.items()):
        if known_metrics and not any(_wild_match(name, p)
                                     for p in known_metrics):
            findings.append(Finding(
                "RD006", rel, line, name,
                f"metric '{name}' is emitted but not cataloged in "
                f"{cat_rel}'s Observability section"))
    for pat in sorted(catalog):
        if not any(_wild_match(name, pat) for name in ext.metrics):
            findings.append(Finding(
                "RD007", cat_rel, _doc_line(catalog_text,
                                            pat.split("*")[0]),
                pat,
                f"metric '{pat}' is cataloged in {cat_rel} but never "
                "emitted"))

    # RD009 / RD010 — declared SLO names vs the cataloged slo.* gauges.
    # Only tokens shaped ``slo.<name>.<suffix>`` with a per-spec gauge
    # suffix and a concrete (wildcard-free) middle segment count as a
    # cataloged SLO name — ``slo.alerts.fired`` (a counter) and
    # ``slo.<name>.firing`` (the placeholder form) do not.
    def slo_tokens(text):
        out: dict = {}
        for tok in _DOC_TOKEN_RE.findall(text):
            parts = tok.split(".")
            if len(parts) == 3 and parts[0] == "slo" and \
                    parts[2] in _SLO_SUFFIXES and \
                    "<" not in parts[1] and "*" not in parts[1]:
                out.setdefault(parts[1], tok)
        return out

    slo_doc = slo_tokens(catalog_text)
    slo_known = slo_tokens(known)
    for name, (rel, line) in sorted(ext.slo_specs.items()):
        if slo_known and name not in slo_known:
            findings.append(Finding(
                "RD009", rel, line, name,
                f"SLO '{name}' is declared in source (SloSpec) but none "
                f"of its slo.{name}.* gauges are cataloged in {cat_rel}"))
    for name, tok in sorted(slo_doc.items()):
        if name not in ext.slo_specs:
            findings.append(Finding(
                "RD010", cat_rel, _doc_line(catalog_text, tok), name,
                f"SLO '{name}' is cataloged in {cat_rel} ({tok}) but "
                "no SloSpec declares it in source"))
    return findings
