"""CP — capture purity: the captured step and the hosted dispatch halves
enqueue device work without waiting for it.

The port's counterpart of the JAX package's jit-purity rules, one CP
rule for each JP rule.  A CUDA graph capture (``torch.cuda.graph``)
records kernels; a host sync inside it raises, but only on the card,
at capture time (device mode arms ``set_sync_debug_mode("error")``
there).  A hosted dispatch half (``suggest_dispatch`` and what it
calls) must return while the card still works, so that the pipeline
overlaps the objective with the next suggest; a sync there serializes
the loop without an error anywhere.  These rules find both from source,
on a machine with no card.

Entry points, in the package and in the root scripts
(``Project.scripts``):

* the body of every ``with torch.cuda.graph(...):`` block;
* every function or method named ``suggest_dispatch`` (the hosted
  dispatch halves);
* the qualnames a module lists in a module-level
  ``CAPTURED_ENTRY_POINTS`` tuple.  That is how a module declares the
  functions that run under another module's capture: device mode's
  step crosses ``device.py`` → ``tpe.py`` → ``ops/*`` → ``space.py``.

Reachability is same-module, as jit-purity's: ``name()`` resolves to a
top-level function, ``self.m()`` to a method of the same class.  A
function whose name contains ``fetch`` is a fetch half, which exists to
sync: it is neither checked nor walked into.  What the walk misses: a
call through another object (``self.kern.step()``, ``mod.fn()``), a
function passed as a value and called later, and anything in another
module that does not declare it in ``CAPTURED_ENTRY_POINTS``.  Those
paths are caught only on the card, by the capture's sync-debug mode.

Tensor values (CP002–CP004, CP006) are inferred lexically, per
function: a name bound from a ``torch.*`` call (not one returning a
host object: a dtype, device, generator, stream, event, size ...), from
a tensor's method (not ``.size()``, ``.dim()``, ``.numel()`` ...), or
from a subscript, arithmetic or comparison with a tensor; a parameter
annotated ``Tensor``; a ``self.X`` that the class assigns from such an
expression anywhere.

CP001  ``.item()``, ``.cpu()``, ``.tolist()`` or ``.numpy()`` — a copy
       to the host that waits for the stream (``.tolist()`` on a value
       known to be a numpy array is exempt).
CP002  ``float()`` / ``int()`` / ``bool()`` on a tensor — a blocking
       read of a device scalar.
CP003  A host numpy call (``np.*``) on a tensor — materializes it on
       the host.
CP004  A Python scalar written into a tensor by subscript assignment
       (``t[k] = 1.0``) — a copy from the host that waits for the
       stream; write ``t[k:k + 1].fill_(1.0)`` or a device tensor.
CP005  ``torch.cuda.synchronize()`` or ``.synchronize()`` on an event or
       stream.  Fetch halves are exempt: they exist to sync.
CP006  Host-side work that reads device results: a Python branch
       (``if`` / ``while`` / ``assert`` / conditional expression) whose
       test calls a tensor predicate (``.any()``, ``.all()``,
       ``torch.equal`` ...) or takes a tensor's truth, or ``.query()`` on
       an event or stream.
CP007  Python-side RNG (``np.random.*``, stdlib ``random.*``, a
       ``.integers()`` Generator draw) where a ``torch.Generator`` is the
       rule: in a capture the draw freezes at capture time, and in a
       dispatch half it escapes the seeded generator streams.
"""

from __future__ import annotations

import ast

from .core import Finding, dotted_name, qualified_functions, str_const

RULES = ("CP001", "CP002", "CP003", "CP004", "CP005", "CP006", "CP007")

#: The module-level tuple that declares captured entry points.
DECLARATION = "CAPTURED_ENTRY_POINTS"

_DISPATCH_HALF = "suggest_dispatch"
_HOST_COPIES = {"item", "cpu", "tolist", "numpy"}
_CASTS = {"float", "int", "bool"}
#: ``torch.<x>`` namespaces and calls that give host objects, not tensors.
_HOST_TORCH = {
    "device", "dtype", "Size", "Generator", "get_default_dtype",
    "is_tensor", "is_floating_point", "is_complex", "numel", "finfo",
    "iinfo", "no_grad", "inference_mode", "enable_grad",
    "set_grad_enabled", "manual_seed", "get_rng_state", "cuda",
    "backends", "distributed", "profiler", "compile", "jit", "autograd",
    "promote_types", "result_type", "can_cast", "is_grad_enabled",
    "typename", "broadcast_shapes", "get_num_threads",
    "set_num_threads", "use_deterministic_algorithms", "equal",
    "is_nonzero", "allclose", "utils", "library", "ops", "testing",
}
#: Tensor methods and attributes that give host values.
_HOST_METHODS = {
    "size", "dim", "numel", "item", "tolist", "stride", "data_ptr",
    "element_size", "is_contiguous", "storage_offset", "get_device",
    "nelement", "ndimension", "numpy", "is_floating_point",
    "is_complex", "untyped_storage", "is_pinned", "equal", "dim_order",
    "type", "__len__", "record_stream",
}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
               "requires_grad", "layout", "grad_fn", "is_leaf", "names"}
_PREDICATES = {"any", "all", "equal", "allclose", "is_nonzero"}


class _ModuleIndex:
    """Symbol tables and import aliases of one module."""

    def __init__(self, module):
        self.module = module
        self.funcs: dict = {}       # name -> FunctionDef (top level)
        self.methods: dict = {}     # (class, name) -> FunctionDef
        self.by_qual: dict = {}     # qualname -> (FunctionDef, class)
        self.torch = {"torch"}
        self.functional: set = set()
        self.np: set = set()
        self.rng: set = set()
        for qual, node, cls in qualified_functions(module.tree):
            self.by_qual[qual] = (node, cls)
            if cls is None:
                self.funcs[node.name] = node
            else:
                self.methods[(cls, node.name)] = node
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch":
                        self.torch.add(a.asname or "torch")
                    elif a.name == "torch.nn.functional" and a.asname:
                        self.functional.add(a.asname)
                    elif a.name == "numpy":
                        self.np.add(a.asname or "numpy")
                    elif a.name in ("random", "numpy.random"):
                        self.rng.add(a.asname or a.name.split(".")[-1])
            elif isinstance(node, ast.ImportFrom):
                if node.module == "numpy":
                    for a in node.names:
                        if a.name == "random":
                            self.rng.add(a.asname or "random")
                elif node.module == "torch.nn":
                    for a in node.names:
                        if a.name == "functional":
                            self.functional.add(a.asname or "functional")
        self.class_tensors = self._class_tensor_attrs()

    # -- tensor inference ----------------------------------------------------

    def is_torch_call(self, name: str | None) -> bool:
        if not name:
            return False
        parts = name.split(".")
        if parts[0] in self.functional:
            return True
        return (parts[0] in self.torch and len(parts) > 1
                and parts[1] not in _HOST_TORCH)

    def is_tensor(self, node, tensors, attrs) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tensors
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in attrs
            if node.attr in _HOST_ATTRS:
                return False
            return node.attr in ("T", "mT", "real", "imag", "data") and \
                self.is_tensor(node.value, tensors, attrs)
        if isinstance(node, ast.Call):
            if self.is_torch_call(dotted_name(node.func)):
                return True
            if isinstance(node.func, ast.Attribute):
                return (node.func.attr not in _HOST_METHODS
                        and self.is_tensor(node.func.value, tensors, attrs))
            return False
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value, tensors, attrs)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left, tensors, attrs) or \
                self.is_tensor(node.right, tensors, attrs)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand, tensors, attrs)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.is_tensor(x, tensors, attrs)
                       for x in [node.left] + node.comparators)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body, tensors, attrs) or \
                self.is_tensor(node.orelse, tensors, attrs)
        return False

    def is_host_array(self, node, hosts) -> bool:
        if isinstance(node, ast.Name):
            return node.id in hosts
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            return name.split(".")[0] in self.np or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("numpy", "tolist"))
        return False

    def local_types(self, fn, attrs):
        """(tensor names, numpy names) bound in ``fn``, to a fixpoint."""
        tensors, hosts = set(), set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in args.args + args.kwonlyargs + args.posonlyargs:
                ann = dotted_name(a.annotation) if a.annotation else ""
                if ann and ann.split(".")[-1] == "Tensor":
                    tensors.add(a.arg)
        for _ in range(3):
            before = (len(tensors), len(hosts))
            for node in ast.walk(fn):
                if isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    value = node.value
                    if value is None:
                        continue
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    tensor = self.is_tensor(value, tensors, attrs)
                    host = self.is_host_array(value, hosts)
                    for tgt in targets:
                        for sub in ast.walk(tgt):
                            if isinstance(sub, ast.Name) and \
                                    isinstance(sub.ctx, ast.Store):
                                if tensor:
                                    tensors.add(sub.id)
                                elif host:
                                    hosts.add(sub.id)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    if self.is_tensor(node.iter, tensors, attrs) and \
                            isinstance(node.target, ast.Name):
                        tensors.add(node.target.id)
            if (len(tensors), len(hosts)) == before:
                break
        return tensors, hosts

    def _class_tensor_attrs(self) -> dict:
        out: dict = {}
        for cls in self.module.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs: set = set()
            methods = [m for m in cls.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            for _ in range(2):
                for m in methods:
                    tensors, _hosts = self.local_types(m, attrs)
                    for node in ast.walk(m):
                        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                            continue
                        if node.value is None or not self.is_tensor(
                                node.value, tensors, attrs):
                            continue
                        targets = node.targets if isinstance(
                            node, ast.Assign) else [node.target]
                        for tgt in targets:
                            if isinstance(tgt, ast.Attribute) and \
                                    isinstance(tgt.value, ast.Name) and \
                                    tgt.value.id == "self":
                                attrs.add(tgt.attr)
            out[cls.name] = attrs
        return out


def _is_fetch(fn) -> bool:
    return "fetch" in (getattr(fn, "name", None) or "")


def _is_graph_ctx(expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    name = dotted_name(expr.func) or ""
    return name.endswith("cuda.graph") or name == "graph"


def _declared(index: _ModuleIndex) -> list:
    out = []
    for node in index.module.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == DECLARATION
                for t in node.targets) and \
                isinstance(node.value, (ast.Tuple, ast.List, ast.Set)):
            for el in node.value.elts:
                qual = str_const(el)
                if qual and qual in index.by_qual:
                    out.append(index.by_qual[qual])
    return out


def _entry_points(index: _ModuleIndex):
    """``(node, class, kind, enclosing)`` per entry: a captured region (a
    function, or a ``with torch.cuda.graph`` block, checked under its
    enclosing function) or a dispatch half."""
    entries = []
    for fn, cls in _declared(index):
        entries.append((fn, cls, "captured", None))
    for qual, fn, cls in qualified_functions(index.module.tree):
        if fn.name == _DISPATCH_HALF:
            entries.append((fn, cls, "dispatch", None))
        for node in ast.walk(fn):
            if isinstance(node, ast.With) and any(
                    _is_graph_ctx(i.context_expr) for i in node.items):
                entries.append((node, cls, "captured", fn))
    return entries


def _resolve(index, node, cls):
    if isinstance(node, ast.Name):
        fn = index.funcs.get(node.id)
        return (fn, None) if fn is not None else None
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self" \
            and cls is not None:
        fn = index.methods.get((cls, node.attr))
        return (fn, cls) if fn is not None else None
    return None


def _reachable(index: _ModuleIndex, entries):
    """BFS over same-module calls; returns ``{id: (node, cls, kind,
    enclosing)}``, fetch halves pruned."""
    seen: dict = {}
    work = list(entries)
    while work:
        node, cls, kind, outer = work.pop()
        if id(node) in seen or _is_fetch(node) or _is_fetch(outer):
            continue
        seen[id(node)] = (node, cls, kind, outer)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            got = _resolve(index, sub.func, cls)
            if got is not None and id(got[0]) not in seen:
                work.append((got[0], got[1], kind, None))
    return seen


def _fn_name(fn, cls):
    name = getattr(fn, "name", "<lambda>")
    return f"{cls}.{name}" if cls else name


def _is_scalar(node) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float))
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)):
        return _is_scalar(node.operand)
    if isinstance(node, ast.Attribute):
        return dotted_name(node) in ("math.inf", "math.nan", "math.pi",
                                     "math.e")
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in _CASTS
    return False


def _is_python_rng(name, node, index) -> bool:
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr == "integers":
        return True
    if not name:
        return False
    parts = name.split(".")
    if parts[0] in index.np and len(parts) > 2 and parts[1] == "random":
        return True
    return len(parts) > 1 and parts[0] in index.rng


def _reads_device(test, index, tensors, attrs) -> bool:
    """Does a branch test read a device result on the host?"""
    for node in ast.walk(test):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            tail = name.split(".")[-1] if name else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else "")
            if tail in _PREDICATES and (
                    name.split(".")[0] in index.torch
                    or (isinstance(node.func, ast.Attribute)
                        and index.is_tensor(node.func.value, tensors,
                                            attrs))):
                return True
    parts = [test]
    while parts:
        node = parts.pop()
        if isinstance(node, ast.BoolOp):
            parts.extend(node.values)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            parts.append(node.operand)
        elif index.is_tensor(node, tensors, attrs):
            return True
    return False


def _check(findings, rel, node, cls, kind, outer, index):
    scope = outer if outer is not None else node
    sym = _fn_name(scope, cls)
    attrs = index.class_tensors.get(cls, set())
    tensors, hosts = index.local_types(scope, attrs)
    where = ("under a CUDA graph capture" if kind == "captured"
             else "in a hosted dispatch half")
    body = node.body if isinstance(node.body, list) else [node.body]
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                name = dotted_name(sub.func)
                attr = sub.func.attr if isinstance(sub.func, ast.Attribute) \
                    else None
                if attr in _HOST_COPIES and not sub.args and not (
                        attr in ("tolist", "numpy")
                        and index.is_host_array(sub.func.value, hosts)):
                    findings.append(Finding(
                        "CP001", rel, sub.lineno, sym,
                        f".{attr}() {where} copies to the host and waits "
                        "for the stream"))
                elif attr == "synchronize" or (
                        name or "").endswith("cuda.synchronize"):
                    findings.append(Finding(
                        "CP005", rel, sub.lineno, sym,
                        f"{name or attr}() {where} waits for the device "
                        "(only a fetch half may)"))
                elif attr == "query" and not sub.args:
                    findings.append(Finding(
                        "CP006", rel, sub.lineno, sym,
                        f".query() {where} reads device progress on the "
                        "host"))
                elif _is_python_rng(name, sub, index):
                    findings.append(Finding(
                        "CP007", rel, sub.lineno, sym,
                        f"Python-side RNG {where} — draw from a "
                        "torch.Generator instead"))
                elif name in _CASTS and sub.args and index.is_tensor(
                        sub.args[0], tensors, attrs):
                    findings.append(Finding(
                        "CP002", rel, sub.lineno, sym,
                        f"{name}() on a tensor {where} reads a device "
                        "scalar on the host"))
                elif name and name.split(".")[0] in index.np and any(
                        index.is_tensor(a, tensors, attrs)
                        for a in sub.args):
                    findings.append(Finding(
                        "CP003", rel, sub.lineno, sym,
                        f"host numpy call {name}() on a tensor {where}"))
            elif isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Subscript) and index.is_tensor(
                            tgt.value, tensors, attrs) and \
                            _is_scalar(sub.value):
                        findings.append(Finding(
                            "CP004", rel, sub.lineno, sym,
                            f"a Python scalar written into a tensor by "
                            f"subscript {where} is a copy from the host "
                            f"that waits for the stream; fill_ a slice"))
            elif isinstance(sub, (ast.If, ast.While, ast.Assert,
                                  ast.IfExp)):
                if _reads_device(sub.test, index, tensors, attrs):
                    findings.append(Finding(
                        "CP006", rel, sub.lineno, sym,
                        f"a Python branch on a device result {where} "
                        "reads it on the host"))


def check(project) -> list:
    findings: list = []
    for module in project.package_modules() + project.script_modules():
        index = _ModuleIndex(module)
        entries = _entry_points(index)
        if not entries:
            continue
        for node, cls, kind, outer in _reachable(index, entries).values():
            _check(findings, module.rel, node, cls, kind, outer, index)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.symbol))
    return findings
