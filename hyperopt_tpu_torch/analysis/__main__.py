"""CLI: ``python -m hyperopt_tpu_torch.analysis [options]``.

Exit codes: 0 — no findings outside the baseline and no stale entries;
1 — new findings or stale baseline entries; 2 — malformed baseline.

``--json`` prints the full machine-readable report (the input of
``hyperopt-tpu-torch-show lint``), including per-checker wall time;
``--write-baseline`` snapshots the current findings into the baseline
file with TODO notes to be annotated; ``--diff BASE`` narrows the
*report* to files changed vs a git ref (the analysis itself still
parses the whole repo — the cross-module reconciliations are only
meaningful over the full project — so full-run semantics are
preserved: a finding in a changed file fires identically to a full
run); ``--sarif OUT`` additionally writes the report as SARIF 2.1.0
for CI diff annotation.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import CHECKERS, default_baseline_path, run_repo
from .core import Baseline

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")


def changed_files(root: str, base: str) -> set:
    """Repo-relative paths changed vs ``base`` (committed + worktree)."""
    out = subprocess.run(
        ["git", "-C", root, "diff", "--name-only", base, "--"],
        capture_output=True, text=True, check=True).stdout
    return {line.strip() for line in out.splitlines() if line.strip()}


def build_report(root, baseline_path, checkers=None, diff_files=None,
                 with_timings=False) -> dict:
    timings: dict = {} if with_timings else None
    findings = run_repo(root, checkers=checkers, timings=timings)
    baseline = Baseline.load(baseline_path)
    if checkers:
        # Partial run: entries owned by checkers that didn't run can't be
        # judged stale — keep only the selected checkers' rules in scope.
        active = set()
        for name in checkers:
            active |= set(CHECKERS[name][1])
        baseline = Baseline(entries=[e for e in baseline.entries
                                     if e.get("rule") in active],
                            path=baseline.path)
    if diff_files is not None:
        # Diff-scoped report: the full project was analyzed (above), so
        # every finding in a changed file is exactly what a full run
        # would produce; findings and baseline staleness for unchanged
        # files are out of scope for this report.
        findings = [f for f in findings if f.file in diff_files]
        baseline = Baseline(entries=[e for e in baseline.entries
                                     if e.get("file") in diff_files],
                            path=baseline.path)
    errors = baseline.validate()
    new, baselined, stale = baseline.match(findings)
    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    report = {
        "root": os.path.abspath(root),
        "baseline": baseline_path,
        "baseline_errors": errors,
        "counts": dict(sorted(counts.items())),
        "new": [f.to_dict() for f in new],
        "baselined": [f.to_dict() for f in baselined],
        "stale": [{"rule": e.get("rule"), "file": e.get("file"),
                   "symbol": e.get("symbol"), "note": e.get("note")}
                  for e in stale],
    }
    if timings is not None:
        report["timings_s"] = dict(sorted(timings.items()))
    if diff_files is not None:
        report["diff_files"] = sorted(diff_files)
    return report


def sarif_from_report(report: dict) -> dict:
    """SARIF 2.1.0 document from a report dict: new findings at level
    ``error`` (they fail the gate), baselined at ``note``."""
    results = []
    rule_ids = set()
    for f, level in ([(x, "error") for x in report["new"]]
                     + [(x, "note") for x in report["baselined"]]):
        rule_ids.add(f["rule"])
        results.append({
            "ruleId": f["rule"],
            "level": level,
            "message": {"text": f"[{f['symbol']}] {f['message']}"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f["file"]},
                    "region": {"startLine": max(1, int(f["line"]))},
                },
            }],
        })
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "hyperopt-tpu-analysis",
                "informationUri":
                    "docs/API.md#invariant-analyzers",
                "rules": [{"id": rid} for rid in sorted(rule_ids)],
            }},
            "results": results,
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.analysis",
        description="Run the invariant analyzer suite over the repo.")
    ap.add_argument("--root", default=".",
                    help="repo root to analyze (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         "hyperopt_tpu_torch/analysis/baseline.json under "
                         "root)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the machine-readable report")
    ap.add_argument("--checker", action="append", choices=sorted(CHECKERS),
                    help="run only this checker (repeatable)")
    ap.add_argument("--diff", metavar="BASE", default=None,
                    help="narrow the report to files changed vs this git "
                         "ref (full project still analyzed)")
    ap.add_argument("--sarif", metavar="OUT", default=None,
                    help="also write the report as SARIF 2.1.0 to OUT")
    ap.add_argument("--write-baseline", action="store_true",
                    help="snapshot current findings into the baseline")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or default_baseline_path(root)

    if args.write_baseline:
        findings = run_repo(root, checkers=args.checker)
        old = Baseline.load(baseline_path)
        notes = {(e["rule"], e["file"], e["symbol"]): e["note"]
                 for e in old.entries if e.get("note")}
        doc = Baseline.render(findings, notes=notes)
        with open(baseline_path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=False)
            f.write("\n")
        print(f"wrote {len(doc['entries'])} entries to {baseline_path}")
        return 0

    diff_files = None
    if args.diff is not None:
        try:
            diff_files = changed_files(root, args.diff)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"--diff {args.diff}: git diff failed: {e}",
                  file=sys.stderr)
            return 2

    report = build_report(root, baseline_path, checkers=args.checker,
                          diff_files=diff_files,
                          with_timings=args.as_json)
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(sarif_from_report(report), f, indent=2)
            f.write("\n")
    if args.as_json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for key in ("new", "baselined"):
            for f in report[key]:
                tag = " (baselined)" if key == "baselined" else ""
                print(f"{f['file']}:{f['line']}: {f['rule']} "
                      f"[{f['symbol']}] {f['message']}{tag}")
        for e in report["stale"]:
            print(f"stale baseline entry: {e['rule']} {e['file']} "
                  f"[{e['symbol']}] — finding no longer fires; delete it")
        for err in report["baseline_errors"]:
            print(f"baseline error: {err}")
        total = sum(report["counts"].values())
        print(f"{total} finding(s): {len(report['new'])} new, "
              f"{len(report['baselined'])} baselined, "
              f"{len(report['stale'])} stale baseline entr(ies); "
              f"counts {report['counts']}")
    if report["baseline_errors"]:
        return 2
    if report["new"] or report["stale"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
