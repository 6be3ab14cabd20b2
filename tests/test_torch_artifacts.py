"""Schema guards of the JSON the port's root scripts print or write.

``chip_smoke.py`` prints JSON records that a reader of a chip run parses
(the kernels line, the contract line, the ``netstore (d) json:``,
``service (b) json:`` and ``show json:`` lines); ``chip_ei_ab.py``
writes ``ei_ab.json``.  The scripts run only on the card, so these
guards read the dict literals that build each record from the source:
a key dropped or renamed there fails here, on the CPU.  The port's
artifact rule (AH001) counts a script as guarded when this file names
its stem.
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The kernels line of the chip contract: every kernel has all of these.
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def _tree(name):
    return ast.parse((ROOT / name).read_text(), filename=name)


def _dict_keys(node):
    return {k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _dumped_dicts(tree):
    """Key sets of the dict literals handed to ``json.dumps``/``json.dump``
    (directly, or one level inside a dict value)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("dumps", "dump") and node.args \
                and isinstance(node.args[0], ast.Dict):
            out.append(node.args[0])
    return out


def _function(tree, name):
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise AssertionError(f"no function {name}")


def test_chip_smoke_kernels_and_contract_lines_schema():
    main = _function(_tree("chip_smoke.py"), "main")
    rows = [node.args[0] for node in ast.walk(main)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "append"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "rows"
            and node.args and isinstance(node.args[0], ast.Dict)]
    assert len(rows) == 1
    assert KERNEL_KEYS <= _dict_keys(rows[0])
    dumped = [_dict_keys(d) for d in _dumped_dicts(main)]
    assert {"kernels"} in dumped
    contract = [d for d in _dumped_dicts(main)
                if _dict_keys(d) == {"ok", "device"}]
    assert len(contract) == 1
    device = contract[0].values[[k.value for k in contract[0].keys]
                                .index("device")]
    assert _dict_keys(device) == {"platform", "kind", "count"}


def test_chip_smoke_phase_json_lines_schema():
    tree = _tree("chip_smoke.py")
    by_phase = {}
    for phase in ("phase_netstore", "phase_service", "phase_show",
                  "phase_lane_uniforms"):
        by_phase[phase] = [_dict_keys(d)
                           for d in _dumped_dicts(_function(tree, phase))]
    assert {"server_suggest_ms", "inprocess_suggest_ms", "n_docs",
            "n_timed", "turns"} <= by_phase["phase_netstore"][0]
    assert {"server_suggest_ms", "server_verb_ms", "inprocess_suggest_ms",
            "store_history_ms", "n_docs", "n_timed",
            "turns"} <= by_phase["phase_service"][0]
    assert {"card", "steps_s", "wal_records", "wal_bytes",
            "lint_findings"} <= by_phase["phase_show"][0]
    assert {"lanes", "floats", "ms", "bound_ms", "plain_ms", "library_ms",
            "library_graph_ms", "bitwise"} <= by_phase[
                "phase_lane_uniforms"][0]


def test_chip_ei_ab_artifact_schema():
    main = _function(_tree("chip_ei_ab.py"), "main")
    result = [node.value for node in ast.walk(main)
              if isinstance(node, ast.Assign)
              and any(isinstance(t, ast.Name) and t.id == "result"
                      for t in node.targets)
              and isinstance(node.value, ast.Dict)]
    assert len(result) == 1
    assert _dict_keys(result[0]) == {"card", "launches_per_window",
                                     "shapes"}
    row = [node.value for node in ast.walk(main)
           if isinstance(node, ast.Assign)
           and any(isinstance(t, ast.Name) and t.id == "row"
                   for t in node.targets)
           and isinstance(node.value, ast.Dict)]
    assert _dict_keys(row[0]) == {"bound_ms", "bound_by"}
    updates = [{kw.arg for kw in node.keywords} for node in ast.walk(main)
               if isinstance(node, ast.Call)
               and isinstance(node.func, ast.Attribute)
               and node.func.attr == "update"]
    assert {"turns", "speedup", "new_over_bound"} in updates
    assert "ei_ab.json" in ast.unparse(main)
