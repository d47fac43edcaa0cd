"""fedlint CLI, with the port's rule set (``repro_torch.analysis.rules``).

    PYTHONPATH=src python -m repro_torch.analysis.fedlint [PATHS...] \\
        [--json OUT] [--select FED001,FED004] [--ignore FED007] \\
        [--list-rules]

The port's self-check:

    PYTHONPATH=src python -m repro_torch.analysis.fedlint src/repro_torch \\
        tests/test_torch_*.py chip_smoke.py tools

Exit codes: 0 = clean (no unwaived findings), 1 = unwaived findings,
2 = usage error (unknown rule code, missing path).  ``--json`` writes
the machine-readable report (schema below) next to the human output;
CI uploads it as an artifact.

JSON schema (``"fedlint": 1``)::

    {"fedlint": 1,
     "paths": [...],                # as given on the command line
     "rules": {"FED001": title, ...},   # the rules that ran
     "findings": [{"file", "line", "col", "rule", "message",
                   "waived", "reason"}, ...],
     "summary": {"files": n, "total": n, "waived": n,
                 "unwaived": n, "by_rule": {"FED003": n, ...}}}
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.core import discover, lint_file
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.waivers import META_RULE


def _parse_codes(spec: str, known: set) -> List[str]:
    codes = [c.strip() for c in spec.split(",") if c.strip()]
    unknown = [c for c in codes if c not in known]
    if unknown:
        raise ValueError(f"unknown rule code(s): {', '.join(unknown)} "
                         f"(known: {', '.join(sorted(known))})")
    return codes


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fedlint",
        description="Repo-invariant static analysis (FED rules).")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run exclusively")
    ap.add_argument("--ignore", default=None,
                    help="comma-separated rule codes to skip")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors already; normalize others
        return 2 if e.code not in (0,) else 0

    known = {r.code for r in RULES}
    if args.list_rules:
        for r in sorted(RULES, key=lambda r: r.code):
            print(f"{r.code}  {r.title}")
            doc = (r.__doc__ or "").strip()
            if doc:
                for ln in doc.splitlines():
                    print(f"    {ln.strip()}")
        return 0

    try:
        selected = list(RULES)
        if args.select:
            codes = set(_parse_codes(args.select, known))
            selected = [r for r in RULES if r.code in codes]
        if args.ignore:
            codes = set(_parse_codes(args.ignore, known))
            selected = [r for r in selected if r.code not in codes]
        files = discover(args.paths)
    except (ValueError, FileNotFoundError) as e:
        print(f"fedlint: error: {e}", file=sys.stderr)
        return 2

    findings = []
    for path, rel in files:
        findings.extend(lint_file(path, rel, selected))

    for f in findings:
        print(f.render())

    waived = sum(1 for f in findings if f.waived)
    unwaived = len(findings) - waived
    by_rule = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    print(f"fedlint: {len(files)} files, {len(findings)} findings "
          f"({waived} waived, {unwaived} unwaived)")

    if args.json:
        report = {
            "fedlint": 1,
            "paths": list(args.paths),
            "rules": {r.code: r.title for r in selected},
            "meta_rule": META_RULE,
            "findings": [f.to_dict() for f in findings],
            "summary": {"files": len(files), "total": len(findings),
                        "waived": waived, "unwaived": unwaived,
                        "by_rule": by_rule},
        }
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
        print(f"fedlint: report written to {args.json}")

    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())
