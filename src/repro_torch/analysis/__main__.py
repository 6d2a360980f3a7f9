"""``python -m repro_torch.analysis`` — run the port's invariant gate.

Exit status 0 iff every finding is grandfathered by the baseline (the
shipped ``analysis-baseline-torch.json`` is empty, so in practice: iff
there are no findings).  The dead-code audit (``--dead-code``) is
report-only and never affects the exit status.  The runtime checks run
on the card unless given ``--device cpu`` (without a GPU they raise).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .deadcode import dead_code_report, format_dead_code
from .findings import (format_findings, load_baseline, split_baselined,
                       write_baseline)
from .lint import run_lint
from .rules import ALL_RULES
from .trace_checks import ALL_TRACE_CHECKS, DESCRIPTIONS, run_trace_checks

DEFAULT_BASELINE = "analysis-baseline-torch.json"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST convention linter (TR1-TR4) + runtime invariant "
                    "checks (TJ1-TJ6) for the PyTorch/CUDA port.")
    p.add_argument("--root", default=".",
                   help="repository root to analyze (default: cwd)")
    p.add_argument("--baseline", metavar="PATH",
                   help="JSON baseline of grandfathered finding keys "
                        f"(default: ROOT/{DEFAULT_BASELINE} where it "
                        "exists); findings in it are reported but don't "
                        "fail the gate")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write all current findings to PATH as the new "
                        "baseline and exit 0")
    p.add_argument("--json", metavar="PATH",
                   help="also dump the full findings report as JSON")
    p.add_argument("--lint-only", action="store_true",
                   help="skip the runtime checks (no kernel wrapper runs; "
                        "pure-AST pass only)")
    p.add_argument("--trace-only", action="store_true",
                   help="skip the AST linter")
    p.add_argument("--checks", metavar="IDS",
                   help="comma-separated subset, e.g. 'TR3,TJ2'")
    p.add_argument("--dead-code", action="store_true",
                   help="append the (report-only) dead-code audit")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule ids and descriptions, then exit")
    p.add_argument("--device", default=None,
                   help="device of the runtime checks: cuda (default) or "
                        "cpu, where the kernel wrappers run their plain "
                        "versions")
    return p


def _selected(args):
    if args.checks:
        ids = {c.strip().upper() for c in args.checks.split(",")}
    else:
        ids = None
    lint_ids = None
    trace_ids = None
    if ids is not None:
        lint_ids = [r for r in ALL_RULES if r.RULE_ID in ids]
        trace_ids = [c for c in ALL_TRACE_CHECKS if c in ids]
        known = {r.RULE_ID for r in ALL_RULES} | set(ALL_TRACE_CHECKS)
        unknown = ids - known
        if unknown:
            raise SystemExit(f"unknown check ids: {sorted(unknown)}; "
                             f"known: {sorted(known)}")
    run_ast = not args.trace_only and (lint_ids is None or lint_ids)
    run_rt = not args.lint_only and (trace_ids is None or trace_ids)
    return run_ast, lint_ids, run_rt, trace_ids


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.RULE_ID}  {rule.DESCRIPTION}")
        for name in ALL_TRACE_CHECKS:
            print(f"{name}  {DESCRIPTIONS[name]}")
        return 0

    run_ast, lint_ids, run_rt, trace_ids = _selected(args)

    findings = []
    if run_ast:
        findings.extend(run_lint(args.root, rules=lint_ids))
    if run_rt:
        findings.extend(run_trace_checks(args.root, checks=trace_ids,
                                         device=args.device))
    findings.sort()

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    baseline = args.baseline
    if baseline is None:
        default = os.path.join(args.root, DEFAULT_BASELINE)
        baseline = default if os.path.exists(default) else None
    baseline_keys = load_baseline(baseline) if baseline else []
    fresh, grandfathered, stale = split_baselined(findings, baseline_keys)

    print(format_findings(fresh, title="findings"))
    if grandfathered:
        print(format_findings(grandfathered,
                              title="grandfathered (baseline)"))
    if stale:
        print(f"stale baseline keys ({len(stale)}) — fixed or moved; "
              "prune them:")
        for key in stale:
            print(f"  {key}")

    dead = None
    if args.dead_code:
        dead = dead_code_report(args.root)
        print()
        print(format_dead_code(dead))

    if args.json:
        payload = {
            "fresh": [f.to_json() for f in fresh],
            "grandfathered": [f.to_json() for f in grandfathered],
            "stale_baseline_keys": stale,
        }
        if dead is not None:
            payload["dead_code"] = dead
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")

    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
