"""``python -m hyperspace_tpu_torch.check`` — run the codebase lint.

Exit codes: 0 clean, 1 findings, 2 usage/internal error. Designed for CI:
``chip_smoke.py``'s ``check`` phase calls :func:`main` and requires 0, and
``--json`` emits a machine-readable findings array for tooling.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.check",
        description="Static program-contract and codebase-invariant lint.",
    )
    parser.add_argument("paths", nargs="*", help="files to lint (default: the package tree)")
    parser.add_argument("--root", default=None, help="repo root (default: auto-detected)")
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule names to run (default: all)",
    )
    parser.add_argument("--json", action="store_true", help="emit findings as JSON")
    parser.add_argument("--list", action="store_true", help="list registered rules and exit")
    args = parser.parse_args(argv)

    from hyperspace_tpu_torch.check.lint import run_lint
    from hyperspace_tpu_torch.check.rules import all_rules

    if args.list:
        for name, rule in sorted(all_rules().items()):
            first = rule.doc.splitlines()[0]
            print(f"{name}: {first}")
        return 0

    rules = [r.strip() for r in args.rules.split(",") if r.strip()] if args.rules else None
    try:
        findings = run_lint(root=args.root, paths=args.paths or None, rules=rules)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"\n{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
