"""tpulint — static invariant checks for the brpc_tpu_torch tree.

Usage:
    python -m brpc_tpu_torch.analysis [paths...]     # default: the package
    python -m brpc_tpu_torch.analysis --list-rules
    python -m brpc_tpu_torch.analysis --rule monotonic-clock brpc_tpu_torch/trace
    python -m brpc_tpu_torch.analysis --format json brpc_tpu_torch/

``python -m brpc_tpu_torch.tools.tpulint`` (the port of
``tools/tpulint.py``) runs the same CLI.

Exit code 0 when every finding is suppressed or absent, 1 otherwise, 2 for
an unknown rule. Suppress a single line with
``# tpulint: disable=<rule>[,<rule>...]`` on that line or a comment line
directly above it.
"""

import argparse
import json
import os
import sys

from brpc_tpu_torch.analysis import core

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpulint", description=__doc__)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint "
                         "(default: brpc_tpu_torch/)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="NAME",
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list rule names and exit")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by comments")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, desc in core.list_rules():
            print(f"{name:24s} {desc}")
        return 0

    paths = args.paths or [_PKG]
    findings = []
    suppressed = []
    try:
        for path in paths:
            res = core.run_lint(path, rules=args.rules)
            findings.extend(res.findings)
            suppressed.extend(res.suppressed)
    except ValueError as e:  # unknown rule name
        print(f"tpulint: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "suppressed": [f.to_dict() for f in suppressed],
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
        if args.show_suppressed:
            for f in suppressed:
                print(f"{f.format()}  [suppressed]")
        n, s = len(findings), len(suppressed)
        print(f"tpulint: {n} finding(s), {s} suppressed", file=sys.stderr)
    return 1 if findings else 0


def run() -> None:
    """``main()`` as a command: its exit code, and exit code 1, quietly,
    when stdout is a pipe closed early (``| head``)."""
    try:
        sys.exit(main())
    except BrokenPipeError:  # output piped to head/less and closed early
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(1)


if __name__ == "__main__":
    run()
