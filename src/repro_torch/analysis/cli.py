"""``python -m repro_torch.analysis check`` — run the static-analysis passes.

    check   lint the port's model code for unrouted raw compute (pass 1),
            judge every kernel's launch models over its whole config space
            on the H100 profiles (pass 2), and cross-check the registry and
            the planner (pass 3); with --db (and --manifest), audit a tuning
            database and campaign manifest (the `campaign check` body).

Exit code: 1 when any error finding is present; ``--strict`` also fails on
warnings (the CI gate). ``--json`` prints the machine-readable report.
Runs on the CPU: nothing is built or launched.

    PYTHONPATH=src python -m repro_torch.analysis check --strict
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .findings import Report

PASSES = ("lint", "legality", "contracts", "db")


def run_checks(
    models_dir: Optional[str] = None,
    platforms: Optional[List[str]] = None,
    db: Optional[str] = None,
    manifest: Optional[str] = None,
    passes: Optional[List[str]] = None,
) -> Report:
    """Programmatic entry point (also the `campaign check` backend)."""
    from . import contracts, db_check, legality, lint

    passes = list(passes or PASSES)
    report = Report()
    if "lint" in passes:
        lint.lint_paths([models_dir or lint.default_models_dir()], report)
    if "legality" in passes:
        legality.check_legality(platforms or legality.default_platforms(), report)
    if "contracts" in passes:
        contracts.check_contracts(report)
    if "db" in passes and db:
        db_check.check_db(db, manifest_path=manifest, report=report)
    return report


def cmd_check(args) -> int:
    passes = [p for p in args.passes.split(",") if p]
    unknown = set(passes) - set(PASSES)
    if unknown:
        print(f"error: unknown pass(es) {sorted(unknown)}; choose from {list(PASSES)}",
              file=sys.stderr)
        return 2
    report = run_checks(
        models_dir=args.models_dir,
        platforms=[p for p in (args.platforms or "").split(",") if p] or None,
        db=args.db,
        manifest=args.manifest,
        passes=passes,
    )
    if args.json:
        print(report.dumps())
    else:
        print(report.format(verbose=args.verbose))
    return report.exit_code(strict=args.strict)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("check", help="run the static-analysis passes")
    pc.add_argument("--models-dir", default=None,
                    help="directory to lint (default: src/repro_torch/models)")
    pc.add_argument("--platforms", default=None,
                    help="comma-separated platform keys for the legality pass (default: "
                         "h100-sxm,h100-pcie and the detected card's)")
    pc.add_argument("--db", default=None, help="tuning database to audit (enables the db pass)")
    pc.add_argument("--manifest", default=None,
                    help="campaign manifest to cross-check against --db")
    pc.add_argument("--passes", default=",".join(PASSES),
                    help="comma-separated subset of passes to run")
    pc.add_argument("--strict", action="store_true", help="exit 1 on warnings too")
    pc.add_argument("--json", action="store_true", help="print the machine-readable report")
    pc.add_argument("--verbose", "-v", action="store_true",
                    help="also print info findings (allowed sites, pruning)")
    pc.set_defaults(fn=cmd_check)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
