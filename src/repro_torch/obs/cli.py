"""`python -m repro_torch.obs` — render and diff observability snapshots.

    repro_torch.obs report --metrics metrics.json [--events 10]
    repro_torch.obs diff a.json b.json

`report` renders a `--metrics-out` snapshot; `diff` compares two snapshots
(canary vs suspect) and names the shifted histograms. The JAX package's
`report --drift` (its drift detector, which prices sites with
`tools/analytic.py`) is not ported yet: `--drift` says so and exits 2.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .export import (
    diff_snapshots,
    format_diff,
    format_snapshot,
    load_snapshot,
)


def cmd_report(ns: argparse.Namespace) -> int:
    if ns.drift:
        print("error: --drift is not ported yet: the drift detector needs the port's "
              "analytic cost model (ROADMAP Queue 1)", file=sys.stderr)
        return 2
    if not ns.metrics:
        print("error: report needs --metrics", file=sys.stderr)
        return 2
    print(format_snapshot(load_snapshot(ns.metrics), max_events=ns.events))
    return 0


def cmd_diff(ns: argparse.Namespace) -> int:
    a = load_snapshot(ns.a)
    b = load_snapshot(ns.b)
    print(format_diff(diff_snapshots(a, b)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.obs", description="observability reports over snapshots"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="render a metrics snapshot")
    rep.add_argument("--metrics", help="metrics snapshot (a --metrics-out file)")
    rep.add_argument("--events", type=int, default=0,
                     help="also print the last N span events")
    rep.add_argument("--drift", action="store_true",
                     help="the drift detector (not ported yet)")
    rep.set_defaults(fn=cmd_report)

    dif = sub.add_parser("diff", help="compare two metrics snapshots (b - a)")
    dif.add_argument("a")
    dif.add_argument("b")
    dif.set_defaults(fn=cmd_diff)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    ns = build_parser().parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    raise SystemExit(main())
