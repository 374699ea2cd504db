"""`python -m repro_torch.obs` — render, diff and drift-check observability data.

    repro_torch.obs report --metrics metrics.json [--events 10]
    repro_torch.obs report --drift --db tuning.json [--platform h100-sxm]
                           [--threshold 1.5] [--live live.json] [--device cpu]
    repro_torch.obs diff a.json b.json

`report` renders a `--metrics-out` snapshot; with `--drift` it replays each
record of a tuning database on the card (or on the CPU with `--device cpu`),
or takes `--live` key->seconds timings instead, and prints the ranked
`campaign drift` report. `diff` compares two snapshots (canary vs suspect)
and names the shifted histograms.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .export import (
    diff_snapshots,
    format_diff,
    format_snapshot,
    load_snapshot,
)


def cmd_report(ns: argparse.Namespace) -> int:
    if not ns.drift and not ns.metrics:
        print("error: report needs --metrics and/or --drift", file=sys.stderr)
        return 2
    if ns.metrics:
        print(format_snapshot(load_snapshot(ns.metrics), max_events=ns.events))
    if ns.drift:
        if not ns.db:
            print("error: --drift needs --db tuning.json", file=sys.stderr)
            return 2
        from ..core.database import TuningDatabase, atomic_write_json
        from .drift import drift_report, format_drift, unreplayable

        db = TuningDatabase(ns.db)
        live = None
        if ns.live:
            with open(ns.live) as f:
                live = {k: float(v) for k, v in json.load(f).items()}
        entries = drift_report(db, platform=ns.platform, threshold=ns.threshold, live=live,
                               seed=ns.seed, device=None if live is not None else ns.device,
                               manifest=ns.manifest)
        left_out = () if live is not None else unreplayable(db, ns.manifest, ns.platform)
        print(format_drift(entries, threshold=ns.threshold, left_out=left_out))
        if ns.json_out:
            atomic_write_json(ns.json_out, {"threshold": ns.threshold,
                                            "entries": [e.to_json() for e in entries]})
        if ns.fail_on_drift and any(e.regressed for e in entries):
            return 1
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

    rep = sub.add_parser("report", help="render a metrics snapshot / drift check")
    rep.add_argument("--metrics", help="metrics snapshot (a --metrics-out file)")
    rep.add_argument("--events", type=int, default=0,
                     help="also print the last N span events")
    rep.add_argument("--drift", action="store_true",
                     help="replay the tuning database's records and rank their drift")
    rep.add_argument("--db", help="tuning database for --drift")
    rep.add_argument("--manifest", default=None,
                     help="campaign manifest: each argument's dtype for the replay")
    rep.add_argument("--platform", default=None, help="only this platform's records")
    rep.add_argument("--threshold", type=float, default=1.5,
                     help="flag sites whose live/tuned ratio exceeds this")
    rep.add_argument("--live", default=None,
                     help="JSON of db key -> live seconds (skips the replay)")
    rep.add_argument("--seed", type=int, default=0, help="seed of the replay's tensors")
    rep.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the replay")
    rep.add_argument("--json-out", default=None, help="write the ranked entries here")
    rep.add_argument("--fail-on-drift", action="store_true",
                     help="exit 1 if any site regressed past the threshold")
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
