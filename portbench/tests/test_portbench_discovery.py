"""A later change adds a configuration, a traffic mix and a metric as new
files and entries: the harness finds each by its name, with no file that
is there edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

RUNNER = """
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from portbench import harness
bench = json.loads(sys.argv[3])
cell = harness.load_cell(bench, "tiny10.hosted_short", 7, "cpu")
result, lines = harness.execute(bench, cell, 0.3, False)
print(harness.HERE)
print(json.dumps(result))
"""


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(harness.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(pb)
    config = json.loads((pb / "configs" / "branin2.json").read_text())
    config.update(name="tiny10", space="flagship", n_dims=10, n_history=60,
                  n_EI_candidates=128)
    (pb / "configs" / "tiny10.json").write_text(json.dumps(config))
    (pb / "traffic" / "hosted_short.json").write_text(json.dumps(
        {"driver": "hosted", "study_more": 3, "warm_studies": 1,
         "profile_studies": 1, "check_steps": 4}))
    (pb / "checks" / "tiny10.hosted_short.json").write_text(json.dumps(
        {"workload": "tiny10.hosted_short",
         "limits": {"ei_gap": {"limit": 1e-3}}}))
    (pb / "metrics" / "window.trials_per_study.py").write_text(
        "def read(run):\n"
        "    return run.window.trials / run.cell.traffic['study_more']\n")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "tiny10", "source": "a test",
                             "file": "portbench/configs/tiny10.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny10.hosted_short",
                               "config": "tiny10", "traffic": "hosted_short",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "window.trials_per_study",
                                "unit": "trials", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny10.hosted_short"]})
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, str(tmp_path), str(harness.ROOT),
         json.dumps(bench)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    here, line = out.stdout.strip().splitlines()[-2:]
    assert Path(here) == pb
    result = json.loads(line)
    assert result["correct"], result["checks"]
    assert "window.trials_per_study" in result["metrics"]
    # The other end-to-end metrics list their cells, and this is none of
    # them; setup_s is every cell's.
    assert set(result["metrics"]) == {"setup_s", "window.trials_per_study"}
    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items())
