#!/usr/bin/env python
"""bourbonlint CLI for the port — static invariant checks over repro_torch.

Usage:
    python port/scripts/lint.py [paths...] [--rules HOTSYNC,DURORDER]
                                [--baseline port/.bourbonlint-baseline.json]
                                [--update-baseline] [--json]
                                [--show-baselined]
    python port/scripts/lint.py --report dead-modules

Paths default to port/repro_torch and the baseline to
port/.bourbonlint-baseline.json (checked in empty).  Exit status is 1
when there are findings not covered by a justified suppression or the
baseline (or, for dead-modules, when a module outside the allowlist is
unreachable), else 0.  Imports neither torch nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

from repro_torch.analysis import (DEAD_MODULE_ALLOWLIST, apply_baseline,  # noqa: E402
                                  dead_module_report, default_rules,
                                  load_baseline, make_baseline, run_lint,
                                  save_baseline)

DEFAULT_BASELINE = os.path.join(REPO_ROOT, "port",
                                ".bourbonlint-baseline.json")


def _report_dead_modules(as_json: bool) -> int:
    rep = dead_module_report(REPO_ROOT, DEAD_MODULE_ALLOWLIST)
    if as_json:
        print(json.dumps(rep, indent=1))
    else:
        print(f"import graph: {rep['reachable']}/{rep['total']} modules "
              f"reachable from {rep['roots']} root files")
        for mod in rep["quarantined"]:
            print(f"  quarantined (allowlisted): {mod}")
        for mod in rep["dead"]:
            print(f"  DEAD: {mod} is unreachable from repro_torch/__init__, "
                  f"the port's tests, chip_smoke.py, port/examples and "
                  f"port/scripts")
        if rep["dead"]:
            print(f"{len(rep['dead'])} dead module(s) outside the "
                  f"allowlist; delete them or add them to "
                  f"DEAD_MODULE_ALLOWLIST with a reason")
    return 1 if rep["dead"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bourbonlint", description=__doc__)
    ap.add_argument("paths", nargs="*",
                    default=[os.path.join(REPO_ROOT, "port", "repro_torch")])
    ap.add_argument("--rules", help="comma-separated rule ids to run")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON file")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to cover current findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--show-baselined", action="store_true",
                    help="also print baselined/suppressed findings")
    ap.add_argument("--report", choices=["dead-modules"],
                    help="run a report instead of the rule checks")
    args = ap.parse_args(argv)

    if args.report == "dead-modules":
        return _report_dead_modules(args.as_json)

    only = args.rules.split(",") if args.rules else None
    rules = default_rules(REPO_ROOT, only=only)
    findings = run_lint(args.paths, rules, root=REPO_ROOT)

    baseline = load_baseline(args.baseline)
    expired = apply_baseline(findings, baseline)
    if args.update_baseline:
        save_baseline(args.baseline, make_baseline(findings))
        print(f"baseline rewritten: {args.baseline}")
        return 0

    new = [f for f in findings if not f.suppressed and not f.baselined]
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings
                         if args.show_baselined
                         or (not f.suppressed and not f.baselined)],
            "new": len(new),
            "expired_baseline": expired,
        }, indent=1))
    else:
        for f in findings:
            if f.suppressed or f.baselined:
                if args.show_baselined:
                    tag = "suppressed" if f.suppressed else "baselined"
                    print(f"  ({tag}) {f.render()}")
                continue
            print(f.render())
        for e in expired:
            print(f"note: baseline entry no longer occurs "
                  f"({e['rule']} {e['path']} {e['message']!r} "
                  f"x{e['count']}); prune with --update-baseline")
        n_supp = sum(1 for f in findings if f.suppressed)
        n_base = sum(1 for f in findings if f.baselined)
        print(f"bourbonlint: {len(new)} new finding(s), "
              f"{n_base} baselined, {n_supp} suppressed")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
