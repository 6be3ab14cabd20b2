"""The PyTorch port's invariant analyzers (``hyperopt_tpu_torch/analysis``)
against the JAX package's, rule by rule.

* **Shared rules** (LK, ES, RT, FP, WP, AH, RD003–RD010): every fixture
  test of ``tests/test_analysis.py`` runs again with its ``run_checker``
  replaced by one that feeds the same sources to both packages' checkers
  (paths mapped: ``hyperopt_tpu/`` → ``hyperopt_tpu_torch/``,
  ``docs/API.md`` → the port's catalog, ``benchmarks/x.py`` → the root
  script ``x.py``, the artifacts contract → ``tests/test_torch_artifacts
  .py``) and requires the same ``(rule, file, line, symbol)`` findings;
  the JAX test's own firing and clean-twin assertions then run on them.
* **The port's own rules**: each capture-purity rule (CP001–CP007, the
  counterpart of jit-purity) fires on its fixture and stays silent on its
  clean twin; RD001/RD002 read any environment variable against the
  catalog's Environment section; AH001 covers the root scripts; WP006
  holds a control-verb catalog.
* Baseline mechanics and the SARIF golden agree with JAX's; the package
  imports the stdlib only and runs with torch, JAX and ``hyperopt_tpu``
  blocked.

Both analysis packages are loaded by file path, never through their
packages' ``__init__`` (which import torch or JAX).
"""

import ast
import importlib
import importlib.util
import inspect
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "hyperopt_tpu_torch" / "analysis"
_PORT = "_hyperopt_tpu_torch_analysis_standalone"
CATALOG = "hyperopt_tpu_torch/analysis/CATALOG.md"


def port():
    """The port's analysis package by file path (no torch import)."""
    mod = sys.modules.get(_PORT)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            _PORT, PORT_DIR / "__init__.py",
            submodule_search_locations=[str(PORT_DIR)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_PORT] = mod
        spec.loader.exec_module(mod)
    return mod


def port_cli():
    port()
    return importlib.import_module(_PORT + ".__main__")


def run_port(checker, sources, files=None):
    analysis = port()
    project = analysis.Project.from_sources(sources, files=files)
    return analysis.CHECKERS[checker][0].check(project)


def fired(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# shared rules: the JAX fixtures through both packages
# ---------------------------------------------------------------------------

def _map_path(rel):
    if rel == "docs/API.md":
        return CATALOG
    if rel == "tests/test_artifacts_contract.py":
        return "tests/test_torch_artifacts.py"
    if rel.startswith("benchmarks/"):
        return rel[len("benchmarks/"):]
    if rel.startswith("hyperopt_tpu/"):
        return "hyperopt_tpu_torch/" + rel[len("hyperopt_tpu/"):]
    return rel


def _unmap_path(rel, jax_rels):
    for j in jax_rels:
        if _map_path(j) == rel:
            return j
    return rel


def _load_jax_tests():
    spec = importlib.util.spec_from_file_location(
        "_jax_test_analysis_for_port", ROOT / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX_TESTS = _load_jax_tests()
_JAX_RUN = _JAX_TESTS.run_checker
jax_analysis = _JAX_TESTS.load_analysis
_SHARED_PREFIXES = ("test_lk", "test_rd003", "test_rd005", "test_rd006",
                    "test_rd009", "test_ah", "test_wp", "test_rt",
                    "test_es", "test_fp")
SHARED = sorted(name for name, fn in vars(_JAX_TESTS).items()
                if name.startswith(_SHARED_PREFIXES) and callable(fn)
                and not inspect.signature(fn).parameters)


def test_every_shared_rule_has_fixtures():
    rules = {name.split("_")[1][:2].upper() for name in SHARED}
    assert rules == {"LK", "RD", "AH", "WP", "RT", "ES", "FP"}
    assert len(SHARED) >= 35


@pytest.mark.parametrize("name", SHARED)
def test_shared_fixture_same_findings_as_jax(name, monkeypatch):
    calls = []

    def both(checker, sources, files=None):
        jax_found = _JAX_RUN(checker, sources, files=files)
        port_found = run_port(
            checker, {_map_path(k): v for k, v in sources.items()},
            files={_map_path(k): v for k, v in (files or {}).items()})
        rels = list(sources) + list(files or {}) + ["docs/API.md"]
        want = sorted((f.rule, f.file, f.line, f.symbol) for f in jax_found)
        got = sorted((f.rule, _unmap_path(f.file, rels), f.line, f.symbol)
                     for f in port_found)
        assert got == want, (checker, sources)
        calls.append(checker)
        return jax_found

    monkeypatch.setattr(_JAX_TESTS, "run_checker", both)
    getattr(_JAX_TESTS, name)()
    assert calls, f"{name} ran no checker"


# ---------------------------------------------------------------------------
# the port's own rule semantics
# ---------------------------------------------------------------------------


def test_rd001_rd002_any_env_var_against_the_environment_section():
    src = {"hyperopt_tpu_torch/fx.py": (
        "import os\n"
        "A = os.environ.get('FIXTURE_A', '')\n"
        "B = os.getenv('FIXTURE_B')\n"
        "C = os.environ['FIXTURE_C']\n"
        "D = 'FIXTURE_D' in os.environ\n"
        "E = 'FIXTURE_E'   # a mention, not a read\n")}
    bare = run_port("registry-drift", src, files={CATALOG: "nothing\n"})
    assert sorted(f.symbol for f in fired(bare, "RD001")) == [
        "FIXTURE_A", "FIXTURE_B", "FIXTURE_C", "FIXTURE_D"]
    env = "## Environment\n\n`FIXTURE_A` `FIXTURE_B` `FIXTURE_C` `FIXTURE_D`\n"
    clean = run_port("registry-drift", src, files={CATALOG: env})
    assert not fired(clean, "RD001") and not fired(clean, "RD002")
    # a name in another section does not catalog it
    elsewhere = run_port("registry-drift", src, files={
        CATALOG: "## Faults\n\n`FIXTURE_A`\n"})
    assert "FIXTURE_A" in {f.symbol for f in fired(elsewhere, "RD001")}
    phantom = run_port("registry-drift", src, files={
        CATALOG: env + "`FIXTURE_GHOST`\n"})
    assert [f.symbol for f in fired(phantom, "RD002")] == ["FIXTURE_GHOST"]
    # docs/API.md's names never count for the environment
    api = run_port("registry-drift", src, files={
        CATALOG: "", "docs/API.md": "## Environment\n\n`FIXTURE_A`\n"})
    assert "FIXTURE_A" in {f.symbol for f in fired(api, "RD001")}


def test_rd_reverse_direction_holds_only_the_port_catalog():
    src = {"hyperopt_tpu_torch/fx.py": (
        "def emit(reg):\n"
        "    reg.counter('fx.hits').inc()\n")}
    # JAX's reference catalogs fx.hits and a metric the port never emits:
    # the first counts for RD006, the second is not the port's to emit.
    found = run_port("registry-drift", src, files={
        CATALOG: "",
        "docs/API.md": "## Observability\n\n`fx.hits` `fx.jax_only`\n"})
    assert not fired(found, "RD006") and not fired(found, "RD007")


def test_ah001_covers_root_scripts_not_the_package():
    src = {"chip_fixture.py": "import json\nprint(json.dumps({}))\n",
           "hyperopt_tpu_torch/obs/fx.py":
               "import json\ndef w(f):\n    json.dump({}, f)\n"}
    bare = run_port("artifact-honesty", src, files={
        "tests/test_torch_artifacts.py": ""})
    assert [f.file for f in fired(bare, "AH001")] == ["chip_fixture.py"]
    guarded = run_port("artifact-honesty", src, files={
        "tests/test_torch_artifacts.py": "def test_chip_fixture(): pass\n"})
    assert not fired(guarded, "AH001")


_WP_CONTROL = (
    "_WAL_VERBS = frozenset({\"zap\"})\n"
    "_MUTATING_VERBS = frozenset({\"zap\"})\n"
    "_CONTROL_VERBS = frozenset({\"shed\", \"fence\"})\n"
    "class MemT:\n"
    "    def state_dict(self):\n"
    "        return {\"docs\": self._docs}\n"
    "    def zap(self):\n"
    "        self._docs.append(1)\n"
    "class Rpc:\n"
    "    def __call__(self, verb, **kw):\n"
    "        if verb in _MUTATING_VERBS:\n"
    "            kw[\"idem\"] = \"k\"\n"
    "        return kw\n"
    "def _dispatch_verb(verb, req, ft):\n"
    "    if verb == \"zap\":\n"
    "        return ft.zap()\n"
    "    if verb == \"shed\":\n"
    "        return {\"level\": req.get(\"level\")}\n"
    "{fence}")


def test_wp006_control_catalog_against_the_dispatcher():
    arm = ("    if verb == \"fence\":\n"
           "        return {\"fenced\": True}\n")
    clean = run_port("wire-protocol", {
        "hyperopt_tpu_torch/srv.py": _WP_CONTROL.replace("{fence}", arm)})
    assert not fired(clean, "WP006") and not fired(clean, "WP002")
    # no arm for a declared control verb: stale declaration
    stale = run_port("wire-protocol", {
        "hyperopt_tpu_torch/srv.py": _WP_CONTROL.replace("{fence}", "")})
    assert [f.symbol for f in fired(stale, "WP006")] == [
        "_CONTROL_VERBS:fence"]
    # a control verb whose arm mutates durable state
    mut = ("    if verb == \"fence\":\n"
           "        return ft.zap()\n")
    mutating = run_port("wire-protocol", {
        "hyperopt_tpu_torch/srv.py": _WP_CONTROL.replace("{fence}", mut)})
    assert "_CONTROL_VERBS:fence" in {f.symbol
                                      for f in fired(mutating, "WP006")}
    # and a control verb also declared mutating: contradiction
    both = _WP_CONTROL.replace("{fence}", arm).replace(
        "_MUTATING_VERBS = frozenset({\"zap\"})",
        "_MUTATING_VERBS = frozenset({\"zap\", \"shed\"})")
    contra = run_port("wire-protocol", {"hyperopt_tpu_torch/srv.py": both})
    assert "_CONTROL_VERBS:shed" in {f.symbol for f in fired(contra, "WP006")}


# ---------------------------------------------------------------------------
# CP — capture purity
# ---------------------------------------------------------------------------


def _captured(body, extra=""):
    """A module whose ``step`` runs under ``torch.cuda.graph``."""
    return {"hyperopt_tpu_torch/fx.py": (
        "import math\n"
        "import random\n"
        "import numpy as np\n"
        "import torch\n"
        + extra +
        "def step(t, k, g):\n" + body +
        "def capture(t, k, g):\n"
        "    graph = torch.cuda.CUDAGraph()\n"
        "    with torch.cuda.graph(graph):\n"
        "        step(t, k, g)\n")}


def _dispatch(body):
    """The same body as a hosted dispatch half."""
    return {"hyperopt_tpu_torch/fx.py": (
        "import math\n"
        "import random\n"
        "import numpy as np\n"
        "import torch\n"
        "def suggest_dispatch(t, k, g):\n" + body)}


def cp(sources, rule):
    return fired(run_port("capture-purity", sources), rule)


CP_CASES = {
    "CP001": ("    x = torch.zeros(4)\n    return x.sum().item()\n",
              "    x = torch.zeros(4)\n    n = np.zeros(3).tolist()\n"
              "    return x.sum() + len(n)\n"),
    "CP002": ("    x = torch.zeros(4)\n    return float(x.max())\n",
              "    n = len(k)\n    return float(n)\n"),
    "CP003": ("    x = torch.ones(3)\n    return np.log(x)\n",
              "    x = torch.ones(3)\n    return torch.log(x) + np.log(2.0)\n"),
    "CP004": ("    m = torch.zeros(8)\n    m[k] = 1.0\n    return m\n",
              "    m = torch.zeros(8)\n    m[k:k + 1].fill_(1.0)\n"
              "    m[0:2] = t[0:2]\n    return m\n"),
    "CP005": ("    x = torch.zeros(4)\n    torch.cuda.synchronize()\n"
              "    return x\n",
              "    x = torch.zeros(4)\n    return x\n"),
    "CP006": ("    x = torch.zeros(4)\n    if (x > 0).any():\n"
              "        return x\n    return -x\n",
              "    x = torch.zeros(4)\n    if k is None:\n        return x\n"
              "    return torch.where(x > 0, x, -x)\n"),
    "CP007": ("    return torch.zeros(4) + np.random.rand()\n",
              "    return torch.rand(4, generator=g)\n"),
}


@pytest.mark.parametrize("rule", sorted(CP_CASES))
def test_cp_rule_fires_under_capture_and_clean_twin_silent(rule):
    bad, ok = CP_CASES[rule]
    hits = cp(_captured(bad), rule)
    assert hits and {f.symbol for f in hits} == {"step"}
    assert not run_port("capture-purity", _captured(ok))


@pytest.mark.parametrize("rule", sorted(CP_CASES))
def test_cp_rule_fires_in_a_dispatch_half(rule):
    bad, ok = CP_CASES[rule]
    hits = cp(_dispatch(bad), rule)
    assert hits and {f.symbol for f in hits} == {"suggest_dispatch"}
    assert not run_port("capture-purity", _dispatch(ok))
    # the same body under another name is no entry point
    assert not run_port("capture-purity", {
        k: v.replace("suggest_dispatch", "suggest_other")
        for k, v in _dispatch(bad).items()})


def test_cp004_the_gp_liar_step_write():
    """The hosted GP dispatch's liar step wrote a scalar through an index
    (``mf2[k] = 1.0``) and waited for the stream; the slice fill does
    not."""
    src = ("import torch\n"
           "class _GpProgram:\n"
           "    def __call__(self, mf, n_eff, m):\n"
           "        mf2 = torch.cat([mf, torch.zeros(m)])\n"
           "        for i in range(m):\n"
           "            mf2[n_eff + i] = 1.0\n"
           "        return mf2\n"
           "def suggest_dispatch(new_ids, domain, trials, seed):\n"
           "    return _get_program()(None, 0, 4)\n"
           "def _get_program():\n"
           "    return _GpProgram()\n")
    hits = cp({"hyperopt_tpu_torch/backends/gp.py": src}, "CP004")
    assert [f.symbol for f in hits] == []    # a call through an object
    declared = src + "CAPTURED_ENTRY_POINTS = ('_GpProgram.__call__',)\n"
    hits = cp({"hyperopt_tpu_torch/backends/gp.py": declared}, "CP004")
    assert [f.symbol for f in hits] == ["_GpProgram.__call__"]
    fixed = declared.replace("mf2[n_eff + i] = 1.0",
                             "mf2[n_eff + i:n_eff + i + 1].fill_(1.0)")
    assert not cp({"hyperopt_tpu_torch/backends/gp.py": fixed}, "CP004")


def test_cp005_fetch_half_is_exempt():
    src = {"hyperopt_tpu_torch/fx.py": (
        "import torch\n"
        "class Sched:\n"
        "    def suggest_dispatch(self, reqs):\n"
        "        rows = torch.zeros(4)\n"
        "        self._enqueue(rows)\n"
        "        return self._fetch_rows(rows)\n"
        "    def _enqueue(self, rows):\n"
        "        rows.add_(1)\n"
        "    def _fetch_rows(self, rows):\n"
        "        torch.cuda.synchronize()\n"
        "        return rows.cpu().tolist()\n")}
    assert not run_port("capture-purity", src)
    unfetched = {k: v.replace("_fetch_rows", "_rows_now")
                 for k, v in src.items()}
    rules = {f.rule for f in run_port("capture-purity", unfetched)}
    assert rules == {"CP001", "CP005"}


def test_cp_same_module_reach_and_declared_entry_points():
    """The walk follows ``name()`` and ``self.m()`` within a module; a
    function run under another module's capture is reached only when its
    module declares it in ``CAPTURED_ENTRY_POINTS``."""
    kern = ("import torch\n"
            "class Kern:\n"
            "    def step(self, x):\n"
            "        return self._score(x)\n"
            "    def _score(self, x):\n"
            "        return _pick(x)\n"
            "    def host_only(self, x):\n"
            "        return x.item()\n"
            "def _pick(x):\n"
            "    return x.max().item()\n")
    seg = ("import torch\n"
           "class Seg:\n"
           "    def _step(self):\n"
           "        return self.kern.step(self.x)\n"
           "    def _capture(self):\n"
           "        g = torch.cuda.CUDAGraph()\n"
           "        with torch.cuda.graph(g):\n"
           "            self._step()\n")
    undeclared = run_port("capture-purity", {
        "hyperopt_tpu_torch/k.py": kern, "hyperopt_tpu_torch/d.py": seg})
    assert undeclared == []
    declared = kern + "CAPTURED_ENTRY_POINTS = ('Kern.step',)\n"
    found = run_port("capture-purity", {
        "hyperopt_tpu_torch/k.py": declared,
        "hyperopt_tpu_torch/d.py": seg})
    assert [(f.rule, f.symbol) for f in found] == [("CP001", "_pick")]


def test_cp_walks_capture_bodies_in_the_root_scripts():
    """A ``torch.cuda.graph`` body in a root script of ``Project.scripts``
    is an entry point; the same body in another root file is not."""
    src = ("import torch\n"
           "def capture(x):\n"
           "    graph = torch.cuda.CUDAGraph()\n"
           "    with torch.cuda.graph(graph):\n"
           "        y = torch.zeros(4)\n"
           "        n = y.sum().item()\n"
           "    return graph, n\n")
    analysis = port()
    assert "graft_entry_torch.py" in analysis.Project.scripts
    hits = cp({"graft_entry_torch.py": src}, "CP001")
    assert [(f.file, f.symbol) for f in hits] == [
        ("graft_entry_torch.py", "capture")]
    assert not run_port("capture-purity", {"other_root.py": src})


def test_cp_declared_entry_points_of_the_port_resolve():
    """Every ``CAPTURED_ENTRY_POINTS`` of the port names a function of its
    module, and the captured step's modules all declare theirs."""
    analysis = port()
    cpm = analysis.CHECKERS["capture-purity"][0]
    project = analysis.Project.from_dir(str(ROOT))
    declaring = {}
    for module in project.package_modules():
        names = None
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == cpm.DECLARATION
                    for t in node.targets):
                names = [e.value for e in node.value.elts]
        if names is None:
            continue
        index = cpm._ModuleIndex(module)
        assert set(names) <= set(index.by_qual), module.rel
        declaring[module.rel] = names
    assert set(declaring) == {
        f"hyperopt_tpu_torch/{m}.py" for m in (
            "tpe", "space", "dispatch", "ops/ei_scores", "ops/fixed_order",
            "ops/gmm", "ops/lane_uniforms", "ops/parzen", "ops/set_weights",
            "ops/step_ei")}
    assert {"_TpeKernel._suggest_lanes", "_TpeKernel.draw_noise",
            "stack_noise", "_insert_row"} <= set(declaring[
                "hyperopt_tpu_torch/tpe.py"])
    # device mode's capture block reaches the step in its own module
    dev = project.module("hyperopt_tpu_torch/device.py")
    index = cpm._ModuleIndex(dev)
    reached = {cpm._fn_name(n, c)
               for n, c, _k, outer in cpm._reachable(
                   index, cpm._entry_points(index)).values()
               if outer is None}
    assert "_Segment._step" in reached


# ---------------------------------------------------------------------------
# baseline, report and CLI plumbing against JAX's
# ---------------------------------------------------------------------------


def _findings(analysis):
    F = analysis.Finding
    return [F("CP001", "hyperopt_tpu_torch/a.py", 3, "f", "m"),
            F("LK002", "hyperopt_tpu_torch/b.py", 9, "g", "m"),
            F("LK002", "hyperopt_tpu_torch/b.py", 12, "g", "m2")]


_ENTRIES = [
    {"rule": "CP001", "file": "hyperopt_tpu_torch/a.py", "symbol": "f",
     "note": "known"},
    {"rule": "AH001", "file": "gone.py", "symbol": "gone",
     "note": "fixed long ago"},
    {"rule": "RT001", "file": "x.py", "symbol": "s", "note": "  "},
    {"rule": "RT001", "symbol": "s", "note": "no file"},
]


def test_baseline_match_validate_render_agree_with_jax():
    mine, theirs = port(), jax_analysis()

    def out(analysis):
        base = analysis.Baseline(entries=[dict(e) for e in _ENTRIES])
        new, old, stale = base.match(_findings(analysis))
        return ([f.to_dict() for f in new], [f.to_dict() for f in old],
                stale, base.validate(),
                analysis.Baseline.render(
                    _findings(analysis),
                    notes={("CP001", "hyperopt_tpu_torch/a.py", "f"): "n"}))

    assert out(mine) == out(theirs)
    new, old, stale, errs, doc = out(mine)
    assert [f["rule"] for f in new] == ["LK002", "LK002"]
    assert [f["rule"] for f in old] == ["CP001"]
    assert [e["symbol"] for e in stale] == ["gone", "s", "s"]
    assert len(errs) == 2
    assert [e["note"] for e in doc["entries"]] == [
        "n", "TODO: annotate or fix"]


def test_checked_in_baseline_is_valid_and_annotated():
    analysis = port()
    base = analysis.Baseline.load(analysis.default_baseline_path(str(ROOT)))
    assert base.entries and base.validate() == []
    assert all(e["file"].startswith("hyperopt_tpu_torch/")
               for e in base.entries)
    # no grandfathered artifact entries
    assert not [e for e in base.entries if e["rule"] == "AH001"]


def test_sarif_output_matches_the_jax_golden():
    got = json.dumps(port_cli().sarif_from_report(_JAX_TESTS._SARIF_REPORT),
                     indent=2, sort_keys=True) + "\n"
    assert got == (ROOT / "tests" / "data"
                   / "analysis_sarif_golden.json").read_text()


def test_report_timings_and_checker_scope():
    cli = port_cli()
    baseline = port().default_baseline_path(str(ROOT))
    report = cli.build_report(str(ROOT), baseline,
                              checkers=["capture-purity"],
                              with_timings=True)
    assert set(report["timings_s"]) == {"capture-purity"}
    assert report["stale"] == [] and report["new"] == []
    assert {f["rule"][:2] for f in report["baselined"]} == {"CP"}
    target = "hyperopt_tpu_torch/service/wal.py"
    diff = cli.build_report(str(ROOT), baseline,
                            checkers=["replay-determinism"],
                            diff_files={target})
    assert diff["diff_files"] == [target] and not diff["new"]
    assert diff["baselined"] and all(f["file"] == target
                                     for f in diff["baselined"])


def test_diff_with_bad_git_ref_exits_2(capsys):
    rc = port_cli().main(["--root", str(ROOT), "--diff", "no-such-ref-xyz"])
    assert rc == 2
    assert "git diff failed" in capsys.readouterr().err


def test_write_baseline_keeps_notes(tmp_path):
    path = tmp_path / "baseline.json"
    src = json.loads((PORT_DIR / "baseline.json").read_text())
    path.write_text(json.dumps(src))
    rc = port_cli().main(["--root", str(ROOT), "--baseline", str(path),
                          "--write-baseline"])
    assert rc == 0
    notes = {(e["rule"], e["file"], e["symbol"]): e["note"]
             for e in json.loads(path.read_text())["entries"]}
    for e in src["entries"]:
        assert notes[(e["rule"], e["file"], e["symbol"])] == e["note"]


# ---------------------------------------------------------------------------
# import independence
# ---------------------------------------------------------------------------


def test_analysis_package_imports_stdlib_only():
    allowed = {"__future__", "ast", "json", "os", "re", "argparse", "sys",
               "dataclasses", "time", "subprocess"}
    for path in sorted(PORT_DIR.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= allowed, f"{path.name} imports {tops}"


def test_runs_with_torch_jax_and_the_jax_package_blocked():
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "torch", "numpy",
                                  "hyperopt_tpu"):
            raise ImportError(name + " is blocked in this test")
        return None
sys.meta_path.insert(0, Block())
import importlib.util
spec = importlib.util.spec_from_file_location(
    "{_PORT}", {str(PORT_DIR / '__init__.py')!r},
    submodule_search_locations=[{str(PORT_DIR)!r}])
mod = importlib.util.module_from_spec(spec)
sys.modules["{_PORT}"] = mod
spec.loader.exec_module(mod)
print(len(mod.run_repo({str(ROOT)!r})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(port().run_repo(str(ROOT)))
