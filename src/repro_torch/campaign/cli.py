"""``python -m repro_torch.campaign`` -- the campaign's command line.

    plan    derive and schedule the jobs, write the resumable manifest
    run     tune the pending jobs best-first (a rerun resumes)
    status  the manifest's progress, the banked speedups, pruned trials
    export  write the one-platform database a deployment ships

Every command runs on the card unless given ``--device cpu``; the manifest
and the database are keyed by the platform of that device (``--platform``
names another namespace). Full width on the card:

    python -m repro_torch.campaign plan --arches qwen2_0_5b --train-shapes train_2k \\
        --serving 8x2048 --budget 240 --out campaign.json
    python -m repro_torch.campaign run --manifest campaign.json --db tuning.json
    python -m repro_torch.campaign export --db tuning.json --out h100.db.json

A small campaign on the CPU (the kernels' plain versions):

    python -m repro_torch.campaign plan --device cpu --reduced --arches qwen2_0_5b \\
        --train-shapes train_smoke --serving 2x32 --budget 120 --out c.json
    python -m repro_torch.campaign run --device cpu --manifest c.json --db db.json
    python -m repro_torch.campaign export --device cpu --db db.json --out cpu.db.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..core.database import TuningDatabase
from ..core.evaluate import WallClockEvaluator
from ..core.platform import detect_platform, resolve_device
from . import planner, runner, scheduler


def _db_path(args) -> str:
    return args.db or ".repro_tuning.json"


def _platform(args) -> str:
    return args.platform or detect_platform(resolve_device(args.device)).name


def _fmt_job(j: planner.TuningJob) -> str:
    shapes = "/".join("x".join(map(str, s)) for s in j.arg_shapes)
    state = j.status if j.budget or j.status != "pending" else "deferred"
    return (f"  [{state:>8}] {j.kernel:<20} {shapes:<40} {j.key_extra:<8} "
            f"budget={j.budget:<4} prio={j.priority:.3g} x {len(j.scenarios)} scenario(s)")


def cmd_plan(args) -> int:
    serving = None
    if args.serving:
        try:
            b, s = args.serving.lower().split("x")
            serving = (int(b), int(s))
        except ValueError:
            raise SystemExit(f"error: --serving expects MAXBATCHxMAXSEQ (e.g. 8x2048), "
                             f"got {args.serving!r}")
    jobs = planner.plan_jobs(
        [a for a in args.arches.split(",") if a],
        train_shapes=[s for s in args.train_shapes.split(",") if s],
        serving=serving,
        kernels=tuple(k for k in args.kernels.split(",") if k),
        reduced=args.reduced,
        max_tokens=args.max_tokens,
        max_seq=args.max_seq,
    )
    profile = detect_platform(resolve_device(args.device))
    manifest = scheduler.build_manifest(jobs, args.budget, path=args.out,
                                        platform=args.platform or profile.name,
                                        profile=profile, min_budget=args.min_budget,
                                        max_budget=args.max_budget)
    print(f"planned {len(jobs)} jobs -> {len(manifest.jobs)} unique keys on "
          f"{manifest.platform} (budget {args.budget} evaluations) -> {args.out}")
    for j in manifest.jobs:
        print(_fmt_job(j))
    return 0


def cmd_run(args) -> int:
    manifest = scheduler.CampaignManifest.load(args.manifest)
    if args.budget is not None:
        pending = [j for j in manifest.jobs if j.status == "pending"]
        scheduler.allocate_budget(pending, args.budget, min_budget=args.min_budget,
                                  max_budget=args.max_budget)
        manifest.total_budget = args.budget
        manifest.save()
    db = TuningDatabase(_db_path(args))
    summary = runner.run_campaign(
        manifest, db,
        evaluator=WallClockEvaluator(repeats=args.repeats, warmup=1),
        max_jobs=args.max_jobs,
        warm_start=not args.no_warm_start,
        max_attempts=args.max_attempts,
        device=resolve_device(args.device),
    )
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0


def cmd_status(args) -> int:
    manifest = scheduler.CampaignManifest.load(args.manifest)
    print(json.dumps(manifest.summary(), indent=1, sort_keys=True))
    for reason, n in sorted((manifest.meta.get("pruned") or {}).items()):
        print(f"  pruned: {n} trial(s), {reason}")
    for j in manifest.jobs:
        line = _fmt_job(j)
        if j.status == "done" and j.best_objective > 0:
            speed = j.default_objective / j.best_objective if j.default_objective > 0 else 0.0
            line += f"  {speed:.2f}x in {j.evaluations} evals"
            if j.seeded:
                line += " (warm)"
        elif j.status == "poisoned":
            line += f"  ERROR after {j.attempts or 1} attempt(s): {j.error[:60]}"
        print(line)
    if manifest.meta.get("telemetry", {}).get("calls"):
        print(runner.format_telemetry(runner.summarize_telemetry(manifest.meta["telemetry"]),
                                      "campaign"))
    return 0


def cmd_export(args) -> int:
    db = TuningDatabase(_db_path(args))
    platform = _platform(args)
    out = runner.export_campaign_db(db, args.out, platform, cover_max_size=args.cover_size)
    covers = {k: len(v) for k, v in out.covers().items()}
    print(f"exported {len(out)} records + {sum(covers.values())} cover entries for "
          f"{platform} -> {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.campaign", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pp = sub.add_parser("plan", help="derive and schedule the jobs, write the manifest")
    common(pp)
    pp.add_argument("--out", default="campaign.json", help="manifest path")
    pp.add_argument("--arches", default="qwen2_0_5b", help="comma-separated arch names")
    pp.add_argument("--train-shapes", default="train_2k", help="comma-separated shape names")
    pp.add_argument("--serving", default="8x2048",
                    help="serving buckets as MAXBATCHxMAXSEQ ('' to skip)")
    pp.add_argument("--kernels", default=",".join(planner.DEFAULT_KERNELS))
    pp.add_argument("--reduced", action="store_true",
                    help="plan the reduced smoke configs (CPU campaigns)")
    pp.add_argument("--budget", type=int, default=256,
                    help="global evaluation budget across all jobs")
    pp.add_argument("--min-budget", type=int, default=6)
    pp.add_argument("--max-budget", type=int, default=128)
    pp.add_argument("--max-tokens", type=int, default=planner.MAX_TOKENS,
                    help="cap on materialized leading (token) dims")
    pp.add_argument("--max-seq", type=int, default=4096,
                    help="cap on the attention sequence length")
    pp.add_argument("--platform", default=None,
                    help="database namespace (default: the device's platform key)")
    pp.set_defaults(fn=cmd_plan)

    pr = sub.add_parser("run", help="tune the pending jobs (resumable)")
    common(pr)
    pr.add_argument("--manifest", default="campaign.json")
    pr.add_argument("--db", default=None, help="tuning database (default .repro_tuning.json)")
    pr.add_argument("--budget", type=int, default=None,
                    help="re-split this global budget over the pending jobs")
    pr.add_argument("--min-budget", type=int, default=6)
    pr.add_argument("--max-budget", type=int, default=128)
    pr.add_argument("--max-jobs", type=int, default=None,
                    help="run at most N jobs this invocation")
    pr.add_argument("--repeats", type=int, default=3, help="timed calls per evaluation")
    pr.add_argument("--no-warm-start", action="store_true",
                    help="search every job cold (no transfer seeds)")
    pr.add_argument("--max-attempts", type=int, default=1,
                    help="attempts per job before it is poisoned")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("status", help="show the campaign's progress")
    ps.add_argument("--manifest", default="campaign.json")
    ps.set_defaults(fn=cmd_status)

    pe = sub.add_parser("export", help="write the one-platform database")
    common(pe)
    pe.add_argument("--db", default=None)
    pe.add_argument("--out", default="platform.db.json")
    pe.add_argument("--platform", default=None,
                    help="platform key (default: the device's)")
    pe.add_argument("--cover-size", type=int, default=4,
                    help="max cover-set entries per kernel")
    pe.set_defaults(fn=cmd_export)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
