"""The port's lint CLI: ``python -m howtotrainyourmamlpytorch_tpu_torch.lint
[--json] [--rule GLxxx ...] [--list-rules] PATH...``; rc 0 clean, 1
findings, 2 a usage error."""

import argparse
import os
import sys

from . import RULES, report_human, report_json, run_lint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m howtotrainyourmamlpytorch_tpu_torch.lint",
                                     description="lint the port for PyTorch/CUDA-graph hazards")
    parser.add_argument("paths", nargs="*", help="files or directories to lint")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument("--rule", action="append", default=[], metavar="GLxxx",
                        help="run only these rule ids (repeatable)")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:
        # --help exits 0 and stays 0; a usage error is 2
        return 0 if exc.code == 0 else 2
    if args.list_rules:
        for rule_id in sorted(RULES):
            print(f"{rule_id}  {RULES[rule_id].title}")
        return 0
    if not args.paths:
        print("lint: at least one path is required", file=sys.stderr)
        return 2
    for path in args.paths:
        if not os.path.exists(path):
            print(f"lint: no such path: {path}", file=sys.stderr)
            return 2
    for rule_id in args.rule:
        if rule_id.upper() not in RULES:
            print(f"lint: unknown rule {rule_id!r} (have {', '.join(sorted(RULES))})", file=sys.stderr)
            return 2
    active, suppressed = run_lint(args.paths, args.rule or None)
    print(report_json(active, suppressed) if args.json else report_human(active, suppressed))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
