"""sparklint CLI (this file's stdout is its contract, like
obs/timeline.py — it is print-rule-exempt by path).

Exit codes: 0 clean, 1 findings (or a --gate-wall breach), 2 usage
error (unknown rule). --json emits the machine schema (version-
stamped; golden-tested); --log appends one JSONL record per run so
a run record can keep the analyzer's wall-time trend, and
--gate-wall FAILS the run when the analysis wall (parse+rules, not
interpreter startup) exceeds the bound, so the lint step can never quietly become the
suite's slowest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence

from sparktorch_tpu_torch.lint import ALL_RULES, rules_by_selector
from sparktorch_tpu_torch.lint.core import run_lint

JSON_SCHEMA_VERSION = 1


def _default_paths() -> List[str]:
    # Lint the installed package when no path is given.
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparktorch_tpu_torch.lint",
        description="sparklint: AST rules for this repo's shipped bug "
                    "classes. Suppress a documented exception with "
                    "`# lint-obs: ok (<why>)` on the finding's line.")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to lint (default: the "
                             "sparktorch_tpu_torch package)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    parser.add_argument("--rule", action="append", default=[],
                        metavar="ID",
                        help="run only this rule (ID or slug; "
                             "repeatable)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--gate-wall", type=float, default=None,
                        metavar="S",
                        help="fail if the analysis wall exceeds S "
                             "seconds")
    parser.add_argument("--log", default=None, metavar="PATH",
                        help="append one JSONL run record to PATH")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.id}  {r.slug:22s} {r.summary}")
        return 0

    try:
        rules = rules_by_selector(args.rule)
    except KeyError as exc:
        known = ", ".join(f"{r.id}/{r.slug}" for r in ALL_RULES)
        print(f"unknown rule: {exc.args[0]} (known: {known})",
              file=sys.stderr)
        return 2

    paths = args.paths or _default_paths()
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    findings, n_files = run_lint(paths, rules)
    wall_s = time.perf_counter() - t0
    if n_files == 0:
        # A gate that scans nothing must never read as green — a path
        # typo in the Makefile would otherwise disarm the tier-1
        # prerequisite forever.
        print(f"no .py files found under: {', '.join(paths)}",
              file=sys.stderr)
        return 2

    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    gate_ok = args.gate_wall is None or wall_s <= args.gate_wall

    if args.json:
        doc = {
            "version": JSON_SCHEMA_VERSION,
            "files_scanned": n_files,
            "wall_s": round(wall_s, 4),
            "rules": [r.id for r in rules],
            "counts": counts,
            "findings": [f.to_dict() for f in findings],
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        status = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"sparklint: {n_files} file(s), {len(rules)} rule(s), "
              f"{status}, {wall_s:.2f}s")

    if not gate_ok:
        print(f"sparklint: analysis wall {wall_s:.2f}s exceeds "
              f"--gate-wall {args.gate_wall:.2f}s", file=sys.stderr)

    if args.log:
        from sparktorch_tpu_torch.obs.telemetry import wall_ts
        record = {
            "ts": wall_ts(),
            "config": "lint",
            "files": n_files,
            "findings": len(findings),
            "counts": counts,
            "wall_s": round(wall_s, 4),
            "gate_wall_s": args.gate_wall,
            "ok": bool(gate_ok and not findings),
        }
        os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
        with open(args.log, "a", encoding="utf-8") as f:  # lint-obs: ok (bench record retention, not telemetry)
            f.write(json.dumps(record) + "\n")

    return 0 if (gate_ok and not findings) else 1
