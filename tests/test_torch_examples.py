"""Every ``examples_torch/`` script runs end to end on the CPU.

The counterpart of ``tests/test_examples.py`` for the port's examples:
each script runs in-process through ``runpy`` with ``--device cpu`` (the
argument goes to the entry points) and ``ho.fmin`` capped at 10
evaluations; ``fmin_device`` in 11 runs at its own budget, as JAX's test
runs JAX's.  06 needs scikit-learn and skips without it.  Each script must
print a result line: ``best``, ``loss`` or ``error`` followed by a finite
number (:data:`RESULT`, the rule ``chip_smoke.py`` holds the scripts to
on the card)."""

import math
import os
import re
import runpy
import sys

import pytest
import torch

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import atpe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
EXAMPLES = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))
RESULT = re.compile(r"\b(?:best|loss|error)\b\s*:?\s*"
                    r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?)")

_real_fmin = ho.fmin


def _capped_fmin(*args, **kwargs):
    kwargs["max_evals"] = min(kwargs.get("max_evals") or 10, 10)
    kwargs.setdefault("show_progressbar", False)
    return _real_fmin(*args, **kwargs)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_jax_example_has_its_port():
    jax_examples = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                          if f.endswith(".py"))
    assert EXAMPLES == jax_examples


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs(script, monkeypatch, capsys, tmp_path):
    if script == "06_sklearn_hpo.py":
        pytest.importorskip("sklearn")
    monkeypatch.setattr(ho, "fmin", _capped_fmin)
    argv = [os.path.join(EXAMPLES_DIR, script), "--device", "cpu"]
    if script == "08_adaptive_tpe.py":
        # The transfer memory goes to a temporary file, and the setting
        # comes back after the test.
        monkeypatch.setattr(atpe, "_transfer_path", atpe._transfer_path)
        argv += ["--transfer-store", str(tmp_path / "atpe_transfer.json")]
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(argv[0], run_name="__main__")
    out = capsys.readouterr().out
    found = [float(m.group(1)) for m in RESULT.finditer(out)]
    assert found and all(math.isfinite(v) for v in found), (
        f"{script} printed no result line:\n{out}")
