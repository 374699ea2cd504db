"""``python -m repro_torch.campaign`` -- the campaign's command line.

    plan    derive and schedule the jobs, write the resumable manifest
    run     tune the pending jobs best-first (a rerun resumes)
    status  the manifest's progress, the banked speedups, pruned trials and
            the configs the launch models prune per kernel
    check   audit the database and manifest (repro_torch.analysis's
            contracts and db passes; --full adds the lint and legality)
    drift   replay each record and rank its slowdown against the record and
            the analytic roofline
    export  write the one-platform database a deployment ships

Every command but ``status`` and ``check`` runs on the card unless given
``--device cpu``; the manifest and the database are keyed by the platform
of that device (``--platform`` names another namespace). Full width on the
card:

    python -m repro_torch.campaign plan --arches qwen2_0_5b --train-shapes train_2k \\
        --serving 8x2048 --budget 240 --out campaign.json
    python -m repro_torch.campaign run --manifest campaign.json --db tuning.json
    python -m repro_torch.campaign check --db tuning.json --manifest campaign.json --strict
    python -m repro_torch.campaign drift --db tuning.json
    python -m repro_torch.campaign export --db tuning.json --out h100.db.json

A small campaign on the CPU (the kernels' plain versions):

    python -m repro_torch.campaign plan --device cpu --reduced --arches qwen2_0_5b \\
        --train-shapes train_smoke --serving 2x32 --budget 120 --out c.json
    python -m repro_torch.campaign run --device cpu --manifest c.json --db db.json
    python -m repro_torch.campaign export --device cpu --db db.json --out cpu.db.json

``plan --train-mesh 2x1`` plans the training step of one rank of a
data-parallel trainer on a 2 x 1 mesh (``launch.train --mesh 2x1``).
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
        train_mesh=args.train_mesh or None,
    )
    profile = detect_platform(resolve_device(args.device))
    # budget flows to the archs whose analytic step time is largest (JAX's plan)
    scen = scheduler.analytic_scenario_seconds(
        [a for a in args.arches.split(",") if a],
        [s for s in args.train_shapes.split(",") if s], reduced=args.reduced, profile=profile)
    manifest = scheduler.build_manifest(jobs, args.budget, path=args.out,
                                        platform=args.platform or profile.name,
                                        profile=profile, min_budget=args.min_budget,
                                        max_budget=args.max_budget, scenario_seconds=scen)
    print(f"planned {len(jobs)} jobs -> {len(manifest.jobs)} unique keys on "
          f"{manifest.platform} (budget {args.budget} evaluations) -> {args.out}")
    for j in manifest.jobs:
        print(_fmt_job(j))
    return 0


def cmd_run(args) -> int:
    manifest = scheduler.CampaignManifest.load(args.manifest)
    if scheduler.manifest_missing_bwd(manifest) and not args.allow_missing_bwd:
        print(f"error: {args.manifest} plans training jobs (@dp scenarios) but no backward "
              "roster: it predates the tuned backward plane and would bank a forward-only "
              "database. Re-plan it, or pass --allow-missing-bwd.", file=sys.stderr)
        return 2
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
        job_timeout=args.job_timeout,
    )
    print(json.dumps(summary, indent=1, sort_keys=True))
    if manifest.meta.get("timed_out"):
        print(f"error: the campaign stopped at a job past --job-timeout: "
              f"{manifest.meta['timed_out']['key']}", file=sys.stderr)
        return 1
    return 0


def cmd_drift(args) -> int:
    """Ranked drift report: replay each record, attribute against the record
    and the analytic roofline."""
    from ..obs import drift as obs_drift

    db = TuningDatabase(_db_path(args))
    entries = obs_drift.drift_report(db, threshold=args.threshold, platform=args.platform,
                                     seed=args.seed, device=resolve_device(args.device),
                                     manifest=args.manifest)
    print(obs_drift.format_drift(entries, args.threshold,
                                 obs_drift.unreplayable(db, args.manifest, args.platform)))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([e.to_json() for e in entries], f, indent=1)
        print(f"wrote drift report -> {args.json_out}")
    if args.fail_on_drift and any(e.regressed for e in entries):
        return 1
    return 0


def cmd_check(args) -> int:
    """Validate the database and manifest through repro_torch.analysis's passes."""
    from ..analysis import run_checks

    passes = ["contracts", "db"]
    if args.full:
        passes = ["lint", "legality"] + passes
    report = run_checks(db=_db_path(args), manifest=args.manifest, passes=passes)
    print(report.format(verbose=args.verbose))
    return report.exit_code(strict=args.strict)


def cmd_status(args) -> int:
    manifest = scheduler.CampaignManifest.load(args.manifest)
    print(json.dumps(manifest.summary(), indent=1, sort_keys=True))
    for reason, n in sorted((manifest.meta.get("pruned") or {}).items()):
        print(f"  pruned: {n} trial(s), {reason}")
    # the launch models' verdicts stamped at plan time: configs the tuner's
    # pre-pass skips, so a budget reads against the legal configs
    for kernel, counts in sorted((manifest.meta.get("legality") or {}).items()):
        if counts.get("pruned"):
            cats = ", ".join(f"{k[len('pruned_'):]} {v}" for k, v in sorted(counts.items())
                             if k.startswith("pruned_"))
            print(f"  legality: {kernel}: pruned {counts['pruned']} of {counts['total']} "
                  f"configs ({counts['legal']} legal; {cats}) on {manifest.platform}")
    for j in manifest.jobs:
        line = _fmt_job(j)
        if j.status == "done" and j.best_objective > 0:
            speed = j.default_objective / j.best_objective if j.default_objective > 0 else 0.0
            line += f"  {speed:.2f}x in {j.evaluations} evals"
            if j.seeded:
                line += " (warm)"
        elif j.status in ("failed", "poisoned"):
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
    pp.add_argument("--train-mesh", default=None,
                    help="plan the training step of one data-parallel rank on this mesh "
                         "(DATAxMODEL, e.g. 2x1): jobs key on the rank's rows under each "
                         "arch's default layout, as a trainer on that mesh dispatches")
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
    pr.add_argument("--job-timeout", type=float, default=None,
                    help="wall-clock bound of one attempt in seconds: past it the job is "
                         "poisoned and the campaign stops (a launch cannot be cancelled)")
    pr.add_argument("--allow-missing-bwd", action="store_true",
                    help="run a training manifest with no backward roster instead of "
                         "refusing it")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("status", help="show the campaign's progress")
    ps.add_argument("--manifest", default="campaign.json")
    ps.set_defaults(fn=cmd_status)

    pk = sub.add_parser("check", help="validate the tuning database and manifest (stale, "
                                      "unlaunchable or unreachable keys, missing backward "
                                      "roster, expert-capacity drift)")
    pk.add_argument("--db", default=None)
    pk.add_argument("--manifest", default=None,
                    help="campaign manifest to cross-check (the backward-roster and "
                         "capacity-drift checks)")
    pk.add_argument("--full", action="store_true",
                    help="also run the lint and legality passes")
    pk.add_argument("--strict", action="store_true", help="exit 1 on warnings too")
    pk.add_argument("--verbose", "-v", action="store_true", help="also print info findings")
    pk.set_defaults(fn=cmd_check)

    pd = sub.add_parser("drift", help="replay the tuned sites and rank regressions against "
                                      "their records and the analytic roofline")
    common(pd)
    pd.add_argument("--db", default=None)
    pd.add_argument("--manifest", default=None,
                    help="campaign manifest: each argument's dtype for the replay (without "
                         "it, records whose arguments mix float dtypes are left out)")
    pd.add_argument("--platform", default=None, help="only this platform's records")
    pd.add_argument("--threshold", type=float, default=1.5,
                    help="flag sites whose live/tuned ratio exceeds this")
    pd.add_argument("--seed", type=int, default=0, help="seed of the replay's tensors")
    pd.add_argument("--json-out", default=None, help="write the ranked entries here")
    pd.add_argument("--fail-on-drift", action="store_true",
                    help="exit 1 if any site regressed past the threshold")
    pd.set_defaults(fn=cmd_drift)

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
