"""Tier-1 gate of the PyTorch port: its analyzers come back clean.

Clean means clean against the port's annotated baseline
(``hyperopt_tpu_torch/analysis/baseline.json``): no finding outside it,
no stale entry (a fixed finding must delete its entry: burn-down, not
amnesty), no malformed entry, within a 20 s budget.  The same run backs
``python -m hyperopt_tpu_torch.analysis`` and
``hyperopt-tpu-torch-show lint``; the diff-scoped report against
``HEAD`` is what a review annotates.  The JAX package's gate
(``tests/test_analysis_gate.py``) covers ``hyperopt_tpu/`` and stays as
it is.
"""

import importlib
import importlib.util
import os
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
PKG_DIR = pathlib.Path(ROOT) / "hyperopt_tpu_torch" / "analysis"
_STANDALONE = "_hyperopt_tpu_torch_analysis_standalone"


def analysis():
    """The port's analysis package by file path (no torch import)."""
    mod = sys.modules.get(_STANDALONE)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            _STANDALONE, PKG_DIR / "__init__.py",
            submodule_search_locations=[str(PKG_DIR)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_STANDALONE] = mod
        spec.loader.exec_module(mod)
    return mod


def cli():
    analysis()
    return importlib.import_module(_STANDALONE + ".__main__")


def test_analyzers_clean_against_baseline_within_budget():
    an = analysis()
    t0 = time.monotonic()
    findings = an.run_repo(ROOT)
    baseline = an.Baseline.load(an.default_baseline_path(ROOT))
    elapsed = time.monotonic() - t0

    assert baseline.validate() == []
    new, _baselined, stale = baseline.match(findings)
    assert not new, "new analyzer findings (fix or annotate+baseline):\n" \
        + "\n".join(f.render() for f in new)
    assert not stale, "stale baseline entries (finding fixed — delete " \
        "the suppression):\n" + "\n".join(
            f"{e['rule']} {e['file']} [{e['symbol']}]" for e in stale)
    assert elapsed <= 20.0, f"analyzer pass took {elapsed:.1f}s (>20s budget)"


def test_partial_checker_run_scopes_baseline_staleness():
    # A --checker subset must not judge the other checkers' baseline
    # entries stale (the RT001 entries belong to replay-determinism).
    report = cli().build_report(ROOT, analysis().default_baseline_path(ROOT),
                                checkers=["lock-order"])
    assert report["stale"] == []
    assert report["new"] == []
    assert {f["rule"] for f in report["baselined"]} == {"LK003"}


def test_diff_scoped_gate_clean_vs_head():
    """``python -m hyperopt_tpu_torch.analysis --diff HEAD``: the scoped
    report agrees with the full gate on the changed files and records
    its scope."""
    try:
        files = cli().changed_files(ROOT, "HEAD")
    except Exception as e:   # no git / not a checkout: wiring untestable
        pytest.skip(f"git diff unavailable: {e}")
    report = cli().build_report(ROOT, analysis().default_baseline_path(ROOT),
                                diff_files=files)
    assert report["diff_files"] == sorted(files)
    assert {f["file"] for f in report["new"]} <= set(files)
    assert not report["new"], (
        "diff-scoped analyzer findings in changed files:\n"
        + "\n".join(f"{f['rule']} {f['file']}:{f['line']}"
                    for f in report["new"]))
    assert not report["stale"], report["stale"]


def test_show_lint_cli_runs_from_repo_root(capsys):
    from hyperopt_tpu_torch import show

    rc = show.main(["lint", "--root", ROOT])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 new" in out and "0 stale" in out


def test_console_script_and_module_entry_points():
    """``hyperopt-tpu-torch-show`` names ``show.main``; ``python -m
    hyperopt_tpu_torch.show lint`` and ``python -m
    hyperopt_tpu_torch.analysis`` exit 0 from the root."""
    pyproject = (pathlib.Path(ROOT) / "pyproject.toml").read_text()
    assert 'hyperopt-tpu-torch-show = "hyperopt_tpu_torch.show:main"' \
        in pyproject
    assert '"analysis/baseline.json"' in pyproject
    env = dict(os.environ, PYTHONPATH=ROOT)
    for args in (["-m", "hyperopt_tpu_torch.show", "lint"],
                 ["-m", "hyperopt_tpu_torch.analysis"]):
        proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr
        assert "0 new" in proc.stdout
