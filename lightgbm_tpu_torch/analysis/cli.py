"""``python -m lightgbm_tpu_torch lint``: the port's analyzer from the
shell (the JAX package's ``analysis/cli.py``).

    python -m lightgbm_tpu_torch lint [paths...] [--check] [--json]
                                [--baseline lint_baseline.json]
                                [--write-baseline] [--rules]

Exit codes: 0 clean, 1 findings, 2 internal analyzer error.
``--check`` is the gate's spelling: the same analysis, with a one-line
verdict.  Paths default to the whole package; a path argument narrows
the AST passes but never the whole-repo passes (the registry, the doc's
freshness, the launch-plan sweeps), which do not depend on which files
were selected.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .core import (LintInternalError, discover_files, load_baseline,
                   rule_catalog, run_lint, write_baseline)


def _repo_root() -> str:
    """The directory that holds the lightgbm_tpu_torch package (the
    repo checkout when run in-tree, site-packages otherwise)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _render(findings, as_json: bool, stream) -> None:
    if as_json:
        json.dump({"findings": [f.as_dict() for f in findings]},
                  stream, indent=1, sort_keys=True)
        stream.write("\n")
        return
    for f in findings:
        loc = "%s:%d" % (f.file, f.line) if f.file else "<repo>"
        stream.write("%s: [%s/%s] %s\n" % (loc, f.pass_name, f.rule,
                                           f.message))
        if f.suggestion:
            stream.write("    -> %s\n" % f.suggestion)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch lint",
        description="prove the port's hot-path invariants statically")
    p.add_argument("paths", nargs="*",
                   help="repo-relative files/dirs to lint "
                        "(default: the whole package)")
    p.add_argument("--check", action="store_true",
                   help="gate mode: terse verdict, exit 1 on any "
                        "finding")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings")
    p.add_argument("--baseline", default="",
                   help="baseline JSON; matching findings are "
                        "grandfathered")
    p.add_argument("--write-baseline", default="",
                   metavar="PATH",
                   help="write current findings to PATH and exit 0")
    p.add_argument("--rules", action="store_true",
                   help="list every rule id and exit")
    args = p.parse_args(argv)

    if args.rules:
        for rule, (pass_name, desc) in sorted(rule_catalog().items()):
            sys.stdout.write("%-24s %-10s %s\n" % (rule, pass_name,
                                                   desc))
        return 0

    root = _repo_root()
    files = None
    if args.paths:
        files = []
        for path in args.paths:
            rel = os.path.relpath(os.path.abspath(path), root)
            rel = rel.replace(os.sep, "/")
            if os.path.isdir(os.path.join(root, rel)):
                files.extend(f for f in discover_files(root)
                             if f.startswith(rel.rstrip("/") + "/"))
            else:
                files.append(rel)
    try:
        if args.baseline:
            # surface a corrupt baseline as exit 2 even with 0 findings
            load_baseline(args.baseline)
        findings = run_lint(root, files=files,
                            baseline_path=args.baseline)
        if args.write_baseline:
            write_baseline(args.write_baseline, findings)
            sys.stdout.write("wrote %d finding(s) to %s\n"
                             % (len(findings), args.write_baseline))
            return 0
    except LintInternalError as e:
        sys.stderr.write("lint: internal error: %s\n" % e)
        return 2

    _render(findings, args.as_json, sys.stdout)
    if findings:
        if args.check:
            sys.stdout.write("lint: FAIL - %d unsuppressed finding(s)\n"
                             % len(findings))
        return 1
    if args.check:
        sys.stdout.write("lint: clean\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
