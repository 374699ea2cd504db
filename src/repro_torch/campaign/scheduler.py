"""Campaign scheduler: dedup -> prioritize -> budget -> resumable manifest.

The port of ``repro.campaign.scheduler``, priced on this package's
hardware profiles:

* **dedup** -- jobs that land on one database key merge; their per-step
  weights add and their scenarios union;
* **priority** -- a job's roofline seconds on the card (the larger of its
  FLOP time and its bytes at the memory rate,
  :func:`repro_torch.tools.analytic.site_roofline_seconds`) times its
  per-step weight: the seconds at stake, optionally scaled by the share of
  analytic step time its scenarios take (:func:`analytic_scenario_seconds`).
  Jobs are tuned best-first;
* **budget** -- a global evaluation budget split in proportion to
  priority, with a floor per job;
* **legality** -- per kernel, the configs its launch models refuse on the
  card before any trial (:func:`plan_legality`), stamped into the manifest
  for ``campaign status``;
* **manifest** -- the schedule and each job's state, written atomically
  after every job, so ``campaign run`` resumes where it stopped.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

from ..core.database import atomic_write_json
from ..core.platform import H100_SXM, HardwareProfile
from ..tools.analytic import site_roofline_seconds
from .planner import TuningJob

def job_roofline_seconds(job: TuningJob, profile: HardwareProfile) -> float:
    """max(FLOP time, memory time) of one execution of the job's site, by
    :func:`repro_torch.tools.analytic.site_roofline_seconds`, so the
    scheduler's priorities and the drift detector's %-of-roofline price a
    site alike."""
    return site_roofline_seconds(job.kernel, job.arg_shapes, job.arg_dtypes[0], profile)


def dedupe_jobs(jobs: Sequence[TuningJob], platform: str) -> List[TuningJob]:
    """Merge jobs that share a database key; weights add, scenarios union."""
    merged: Dict[str, TuningJob] = {}
    for job in jobs:
        key = job.db_key(platform)
        prev = merged.get(key)
        if prev is None:
            merged[key] = dataclasses.replace(job)
        else:
            prev.weight += job.weight
            prev.scenarios = tuple(sorted(set(prev.scenarios) | set(job.scenarios)))
    return sorted(merged.values(), key=lambda j: (j.kernel, j.arg_shapes, j.key_extra))


def analytic_scenario_seconds(
    arch_names: Sequence[str],
    train_shapes: Sequence[str] = ("train_2k",),
    reduced: bool = False,
    profile: HardwareProfile = H100_SXM,
    chips: int = 1,
) -> Dict[str, float]:
    """Analytic step seconds per training scenario (``tools/analytic.py``):
    the cross-arch weighting, so a job from an arch whose step costs ten
    times more gets a proportionally larger share of the budget."""
    from ..configs import SHAPES, get_config
    from ..tools import analytic

    out: Dict[str, float] = {}
    for name in arch_names:
        cfg = get_config(name)
        if reduced:
            cfg = cfg.reduced()
        for shape_name in train_shapes:
            shape = SHAPES[shape_name]
            fl = analytic.step_flops(cfg, shape)
            hbm = analytic.step_hbm_bytes(cfg, shape, chips=chips, model_par=1)
            out[f"{cfg.name}/{shape.name}"] = max(fl["total"] / chips / profile.peak_flops_bf16,
                                                  hbm["total"] / profile.hbm_bandwidth)
    return out


def prioritize_jobs(jobs: Sequence[TuningJob], profile: HardwareProfile = H100_SXM,
                    scenario_seconds: Optional[Dict[str, float]] = None) -> List[TuningJob]:
    """Rank by seconds at stake: roofline time of one execution times the
    per-step weight, highest first. With ``scenario_seconds`` (see
    :func:`analytic_scenario_seconds`) each job's stake is also scaled by
    the share of the analytic step time its scenarios take."""
    total_scen = sum(scenario_seconds.values()) if scenario_seconds else 0.0
    out = []
    for job in jobs:
        j = dataclasses.replace(job)
        j.priority = job_roofline_seconds(j, profile) * max(j.weight, 1e-9)
        if scenario_seconds and total_scen > 0:
            known = [scenario_seconds[sc.split("@")[0]] for sc in j.scenarios
                     if sc.split("@")[0] in scenario_seconds]
            if known:
                j.priority *= sum(known) / total_scen * len(scenario_seconds)
        out.append(j)
    out.sort(key=lambda j: (-j.priority, j.kernel, j.arg_shapes, j.key_extra))
    return out


def allocate_budget(jobs: Sequence[TuningJob], total_budget: int, min_budget: int = 6,
                    max_budget: int = 128) -> List[TuningJob]:
    """Split ``total_budget`` evaluations across jobs in proportion to
    priority, each funded job getting at least ``min_budget``. The tail the
    total cannot fund at the floor is deferred (budget 0, kept in the
    manifest)."""
    jobs = list(jobs)
    n_funded = max(0, min(len(jobs), total_budget // min_budget))
    funded, deferred = jobs[:n_funded], jobs[n_funded:]
    total_pri = sum(j.priority for j in funded) or 1.0
    remaining = total_budget - min_budget * len(funded)
    for j in funded:
        extra = int(remaining * (j.priority / total_pri))
        j.budget = min(max_budget, min_budget + extra)
    # Spend what the max_budget clamp and the rounding left, best-first.
    leftover = total_budget - sum(j.budget for j in funded)
    for j in funded:
        if leftover <= 0:
            break
        add = min(max_budget - j.budget, leftover)
        j.budget += add
        leftover -= add
    for j in deferred:
        j.budget = 0
    return funded + deferred


@dataclasses.dataclass
class CampaignManifest:
    """The persisted campaign: schedule plus execution state."""

    path: Optional[str]
    platform: str
    jobs: List[TuningJob]
    created: float = dataclasses.field(default_factory=time.time)
    total_budget: int = 0
    meta: Dict = dataclasses.field(default_factory=dict)

    def save(self) -> None:
        if not self.path:
            return
        atomic_write_json(self.path, {
            "version": 1,
            "platform": self.platform,
            "created": self.created,
            "total_budget": self.total_budget,
            "meta": self.meta,
            "jobs": [j.to_json() for j in self.jobs],
        })

    @staticmethod
    def load(path: str) -> "CampaignManifest":
        with open(path) as f:
            blob = json.load(f)
        return CampaignManifest(
            path=path,
            platform=blob["platform"],
            jobs=[TuningJob.from_json(j) for j in blob["jobs"]],
            created=blob.get("created", 0.0),
            total_budget=blob.get("total_budget", 0),
            meta=blob.get("meta", {}),
        )

    def pending(self) -> List[TuningJob]:
        """Runnable jobs, highest priority first."""
        out = [j for j in self.jobs if j.status == "pending" and j.budget > 0]
        out.sort(key=lambda j: -j.priority)
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {"pending": 0, "done": 0, "poisoned": 0, "deferred": 0}
        for j in self.jobs:
            if j.status == "pending" and j.budget == 0:
                out["deferred"] += 1
            else:
                out[j.status] = out.get(j.status, 0) + 1
        return out

    def summary(self) -> Dict:
        done = [j for j in self.jobs if j.status == "done"]
        speedups = [j.default_objective / j.best_objective for j in done
                    if j.best_objective > 0 and j.default_objective > 0]
        legality = self.meta.get("legality") or {}
        return {
            "platform": self.platform,
            "jobs": len(self.jobs),
            **self.counts(),
            "evaluations_spent": sum(j.evaluations for j in self.jobs),
            "total_budget": self.total_budget,
            "mean_speedup": (sum(speedups) / len(speedups)) if speedups else 0.0,
            "seeded_jobs": sum(1 for j in done if j.seeded),
            "configs_pruned": sum(v.get("pruned", 0) for v in legality.values()),
        }


def plan_legality(jobs: Sequence[TuningJob],
                  profile: HardwareProfile = H100_SXM) -> Dict[str, Dict[str, int]]:
    """Per kernel of the plan that has launch models
    (:mod:`repro_torch.core.gridmodel`): the configs of its space, those its
    models refuse on ``profile`` at the nominal shapes (the tuner's pre-pass
    prunes them before any trial, so the budget is spread over the legal
    ones), and the refusals by category. ``campaign status`` prints them."""
    from ..core.gridmodel import registered_models, space_report

    models = registered_models()
    out: Dict[str, Dict[str, int]] = {}
    for kernel in sorted({j.kernel for j in jobs}):
        if kernel not in models:
            continue
        r = space_report(kernel, profile)
        out[kernel] = {"total": r["total"], "legal": r["legal"], "pruned": r["illegal"],
                       **{f"pruned_{c}": n for c, n in sorted(r["by_category"].items())}}
    return out


def manifest_missing_bwd(manifest: CampaignManifest) -> bool:
    """True when a training manifest predates the tuned backward plane: it
    carries ``@dp`` training scenarios (the training planner's marker) but
    not one ``*_bwd`` job, and its meta does not say the plan is
    forward-only on purpose. Running it banks a forward-only database, so the
    step's gradient sites never hit exactly; ``campaign run`` refuses it
    unless given ``--allow-missing-bwd``. Serving manifests are forward-only
    by design and never flagged."""
    has_train = any(any("@dp" in s for s in j.scenarios) for j in manifest.jobs)
    if not has_train or manifest.meta.get("bwd_roster"):
        return False
    return not any(j.kernel.endswith("_bwd") for j in manifest.jobs)


def build_manifest(jobs: Sequence[TuningJob], total_budget: int, path: Optional[str] = None,
                   platform: Optional[str] = None, profile: HardwareProfile = H100_SXM,
                   min_budget: int = 6, max_budget: int = 128,
                   scenario_seconds: Optional[Dict[str, float]] = None) -> CampaignManifest:
    """Plan output -> deduplicated, prioritized, budgeted, saved schedule.
    ``platform`` (the database namespace) defaults to the profile's name.
    The manifest's meta records whether the plan carries the backward
    roster (``bwd_roster``) and the plan's legality counts (``legality``)."""
    platform = platform or profile.name
    scheduled = allocate_budget(
        prioritize_jobs(dedupe_jobs(jobs, platform), profile, scenario_seconds),
        total_budget, min_budget=min_budget, max_budget=max_budget)
    m = CampaignManifest(path=path, platform=platform, jobs=list(scheduled),
                         total_budget=total_budget)
    m.meta["bwd_roster"] = any(j.kernel.endswith("_bwd") for j in scheduled)
    m.meta["legality"] = plan_legality(scheduled, profile)
    m.save()
    return m
