"""The import rule: nothing the benchmark runs imports JAX or the JAX
package (top-level names compared whole), the reference imports nothing of
the program, and nothing reads the JAX package's benchmark files."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

PB = Path(harness.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "hyperopt_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(PB)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "hyperopt_tpu_torch" not in set(_imports(path))
    assert "portbench" not in set(_imports(path))


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_nothing_reads_the_jax_benchmarks(path):
    text = path.read_text()
    if path.name == "test_portbench_imports.py":
        return
    for name in ("benchmarks/", "bench.py", "chip_smoke"):
        assert name not in text, name


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hyperopt_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hyperopt_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["hyperopt_tpu", "jaxlib"]


def test_a_run_loads_no_jax():
    # In a fresh interpreter the JAX tests' imports would not be there.
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench.tests.tiny import tiny_cell; "
            "from portbench import harness; "
            "b, c = tiny_cell('branin2.studies200'); "
            "harness.execute(b, c, 0.2, False); "
            "print(harness.forbidden_modules())") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
